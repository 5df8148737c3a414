"""The native library is built from tracked sources, not committed,
and the pipeline's ingest choice reports a library it cannot use."""

from __future__ import annotations

import multiprocessing
import os
import shutil
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
import oracle  # noqa: E402

from genrich_tpu import pipeline  # noqa: E402
from genrich_tpu.errors import ERRGEN, GenrichError  # noqa: E402
from genrich_tpu.ingest import native  # noqa: E402
from genrich_tpu.params import parse_args  # noqa: E402


def _copy_sources(d) -> None:
    for name in ("ingest.cpp", "Makefile"):
        shutil.copy(os.path.join(native.NATIVE_DIR, name), str(d))


def test_library_path_is_gitignored():
    with open(os.path.join(oracle.REPO, ".gitignore")) as f:
        ignored = f.read().split()
    assert "native/libgenrich_ingest.so" in ignored
    assert os.path.join(native.NATIVE_DIR, native.SO_NAME) == \
        os.path.join(oracle.REPO, "native", "libgenrich_ingest.so")


def test_build_from_source_and_rebuild_on_change(tmp_path):
    _copy_sources(tmp_path)
    so = tmp_path / native.SO_NAME
    assert native.build(str(tmp_path)) > 0 and so.exists()
    stamp = (tmp_path / ".build.sha256").read_text()
    assert native.build(str(tmp_path)) == 0.0      # current: no rebuild
    with open(tmp_path / "ingest.cpp", "a") as f:
        f.write("\n// a change to the source\n")
    assert native.build(str(tmp_path)) > 0
    assert (tmp_path / ".build.sha256").read_text() != stamp
    assert not list(tmp_path.glob(".build.*.so"))   # no temp left


def _build_in(d):
    return native.build(d)


def test_concurrent_builds_serialize(tmp_path):
    """Several processes starting on a checkout with no library (the
    xdist workers of a fresh checkout) build it once between them."""
    _copy_sources(tmp_path)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(4) as pool:
        secs = pool.map(_build_in, [str(tmp_path)] * 4, chunksize=1)
    assert sum(1 for s in secs if s > 0) == 1, secs
    assert (tmp_path / native.SO_NAME).exists()


def _params(tmp_path, ingest):
    sam = tmp_path / "in.sam"
    oracle.random_sam(str(sam), seed=5)
    return parse_args(["-t", str(sam), "-o", str(tmp_path / "out.np"),
                       "-y", "-p", "0.01", "-a", "20",
                       "--ingest", ingest])


@pytest.fixture
def unloadable(monkeypatch):
    def refuse():
        raise native.NativeUnavailable("loading libgenrich_ingest.so: "
                                       "refused by the test")
    monkeypatch.setattr(native, "_load", refuse)


def test_ingest_native_unloadable_is_fatal(tmp_path, unloadable):
    with pytest.raises(GenrichError) as e:
        pipeline.run(_params(tmp_path, "native"))
    assert e.value.code == ERRGEN
    assert "refused by the test" in e.value.render()


def test_ingest_auto_unloadable_warns_and_falls_back(tmp_path, unloadable,
                                                     capsys):
    perf: dict = {}
    pipeline.run(_params(tmp_path, "auto"), perf=perf)
    err = capsys.readouterr().err
    assert "refused by the test; using the Python ingest" in err
    assert perf["ingest"] == "python"
    assert (tmp_path / "out.np").read_text()
