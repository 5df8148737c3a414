"""Persistent serve mode (--serve): engines and programs reused.

Drives the real subprocess protocol: READY, one analysis per stdin
line, OK/ERR status lines, warm repeats byte-identical to cold, and
the exact engine's output still byte-identical to a fresh-process
run.
"""

from __future__ import annotations

import os
import subprocess
import sys

import conftest  # noqa: F401
import oracle


def _serve(tmp_path, lines, timeout=300):
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": oracle.REPO})
    r = subprocess.run(
        [sys.executable, "-m", "genrich_tpu", "--serve"],
        input="\n".join(lines) + "\nEXIT\n", capture_output=True,
        text=True, cwd=str(tmp_path), env=env, timeout=timeout)
    assert r.returncode == 0, r.stderr[-1500:]
    return r.stdout.splitlines()

def test_serve_warm_runs_identical(tmp_path):
    oracle.random_sam(str(tmp_path / "in.sam"), seed=11)
    base = "-t in.sam -y -p 0.01 -a 20"
    out = _serve(tmp_path, [
        f"{base} -o exact.np",
        f"{base} -o jax0.np --engine jax",
        f"{base} -o jax1.np --engine jax",
        f"{base} -o sh0.np --engine sharded",
        f"{base} -o sh1.np --engine sharded",
        "bogus --flags",
        f"{base} -o exact2.np",
    ])
    assert out[0] == "READY"
    statuses = [ln.split()[0] for ln in out[1:]]
    assert statuses == ["OK", "OK", "OK", "OK", "OK", "ERR", "OK"]
    # warm == cold per engine (programs reused, state fully released)
    assert (tmp_path / "jax0.np").read_bytes() \
        == (tmp_path / "jax1.np").read_bytes()
    assert (tmp_path / "sh0.np").read_bytes() \
        == (tmp_path / "sh1.np").read_bytes()
    # an ERR line must not poison later analyses
    assert (tmp_path / "exact.np").read_bytes() \
        == (tmp_path / "exact2.np").read_bytes()
    # exact serve output == fresh-process run
    d = tmp_path / "fresh"
    d.mkdir()
    r = oracle.run_ours(["-t", str(tmp_path / "in.sam"), "-o",
                         "out.np", "-y", "-p", "0.01", "-a", "20"],
                        cwd=str(d))
    assert r.returncode == 0
    assert (d / "out.np").read_bytes() \
        == (tmp_path / "exact.np").read_bytes()


def test_serve_checkpoint_resume(tmp_path):
    """-X / -P through one server: the stats-log checkpoint written by
    one analysis is re-analyzed by a later line in the same process,
    byte-identical to a fresh-process -P run.  (Full-vs-resumed peak
    rows are NOT bitwise equal — the -f log's printed precision loses
    float32 digits — and the reference behaves the same way.)"""
    oracle.random_sam(str(tmp_path / "in.sam"), seed=17)
    out = _serve(tmp_path, [
        "-t in.sam -o x.np -y -X -f stats.log",
        "-P -f stats.log -o resumed.np -p 0.01 -a 20",
    ])
    assert [ln.split()[0] for ln in out] == ["READY", "OK", "OK"]
    d = tmp_path / "freshp"
    d.mkdir()
    r = oracle.run_ours(["-P", "-f", str(tmp_path / "stats.log"),
                         "-o", "out.np", "-p", "0.01", "-a", "20"],
                        cwd=str(d))
    assert r.returncode == 0
    assert (d / "out.np").read_bytes() \
        == (tmp_path / "resumed.np").read_bytes()
    assert (tmp_path / "resumed.np").read_bytes()


def test_serve_survives_unexpected_errors(tmp_path):
    """A non-Genrich exception (e.g. unwritable output path) must not
    kill the server; later analyses still succeed."""
    oracle.random_sam(str(tmp_path / "in.sam"), seed=19)
    out = _serve(tmp_path, [
        "-t in.sam -o /nonexistent_dir/x.np -y",
        "-t in.sam -o ok.np -y -p 0.01 -a 20",
    ])
    assert [ln.split()[0] for ln in out] == ["READY", "ERR", "OK"]
    assert (tmp_path / "ok.np").stat().st_size > 0


def test_serve_ok_line_carries_decomposition(tmp_path):
    """OK lines embed the per-analysis perf decomposition as JSON:
    stage walls (ingest) always; upload/dispatch/fetch accounting for
    device engines (the bench protocol parses this)."""
    import json
    oracle.random_sam(str(tmp_path / "in.sam"), seed=13)
    base = "-t in.sam -y -p 0.01 -a 20"
    out = _serve(tmp_path, [
        f"{base} -o exact.np",
        f"{base} -o jax.np --engine jax",
    ])
    oks = [ln for ln in out if ln.startswith("OK")]
    assert len(oks) == 2
    for ln in oks:
        parts = ln.split(None, 2)
        assert len(parts) == 3, ln
        perf = json.loads(parts[2])
        assert "ingest_s" in perf
    jax_perf = json.loads(oks[1].split(None, 2)[2])
    for key in ("upload_bytes", "dispatch_n", "fetch_s"):
        assert key in jax_perf, jax_perf
    assert jax_perf["upload_bytes"] > 0
    assert jax_perf["dispatch_n"] > 0


def test_serve_heterogeneous_inputs_reprepare(tmp_path):
    """A serve process fed inputs of different shapes must re-derive
    its shape policy per analysis (round-3 advisor finding: the old
    prepare-once guard kept the first input's bucket/grid forever).
    Larger-after-smaller is the correctness-critical direction."""
    oracle.random_sam(str(tmp_path / "small.sam"), seed=21,
                      n_pairs=80)
    oracle.random_sam(str(tmp_path / "big.sam"), seed=22,
                      n_pairs=900)
    for engine in ("jax", "sharded"):
        out = _serve(tmp_path, [
            f"-t small.sam -y -p 0.01 -a 20 -o s_{engine}.np "
            f"--engine {engine}",
            f"-t big.sam -y -p 0.01 -a 20 -o b_{engine}.np "
            f"--engine {engine}",
        ])
        assert sum(1 for ln in out if ln.startswith("OK")) == 2, out
        # fresh-process oracle for the big input
        r = oracle.run_ours(["-t", str(tmp_path / "big.sam"), "-y",
                             "-p", "0.01", "-a", "20", "-o",
                             "fresh.np", "--engine", engine],
                            cwd=str(tmp_path),
                            env={"JAX_PLATFORMS": "cpu"})
        assert r.returncode == 0, r.stderr[-800:]
        assert (tmp_path / f"b_{engine}.np").read_text() \
            == (tmp_path / "fresh.np").read_text()
