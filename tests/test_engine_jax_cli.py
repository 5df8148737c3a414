"""Device-engine CLI paths (--engine jax / sharded) vs the exact engine.

The sharded variant runs every numeric stage as a shard_map over the
virtual 8-device CPU mesh (tests/conftest.py): BAM/SAM in -> sharded
tiles -> narrowPeak out, exercising the full product path of
engine/sharded_bridge.py.
"""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
import oracle  # noqa: E402

ENGINES = ["jax", "sharded"]


def _env():
    os.environ.update({"JAX_PLATFORMS": "cpu"})


def _run(tmp_path, name, extra, infile="in.sam"):
    d = tmp_path / name
    d.mkdir()
    r = oracle.run_ours(
        ["-t", str(tmp_path / infile), "-o", "out.np", "-y",
         "-p", "0.01", "-a", "20"] + extra, cwd=str(d))
    assert r.returncode == 0, r.stderr[-1500:]
    return (d / "out.np").read_text().splitlines()


@pytest.mark.parametrize("engine", ENGINES)
def test_device_engine_matches_exact_boundaries(tmp_path, engine):
    oracle.random_sam(str(tmp_path / "in.sam"), seed=71)
    _env()
    exact = _run(tmp_path, "exact", [])
    fast = _run(tmp_path, engine, ["--engine", engine])
    assert len(exact) == len(fast)
    for a, b in zip(exact, fast):
        fa, fb = a.split("\t"), b.split("\t")
        # identical coordinates/name/score/strand; float columns close
        assert fa[:6] == fb[:6], (a, b)
        for i in (6, 7):
            x, y = float(fa[i]), float(fb[i])
            assert abs(x - y) <= 1e-4 * max(1.0, abs(x)), (a, b)


@pytest.mark.parametrize("engine", ENGINES)
def test_device_engine_bam_input(tmp_path, engine):
    oracle.random_sam(str(tmp_path / "in.sam"), seed=77)
    oracle.sam_to_bam(str(tmp_path / "in.sam"),
                      str(tmp_path / "in.bam"))
    _env()
    exact = _run(tmp_path, "exact", [], infile="in.bam")
    fast = _run(tmp_path, engine, ["--engine", engine],
                infile="in.bam")
    assert exact and len(exact) == len(fast)
    for a, b in zip(exact, fast):
        assert a.split("\t")[:6] == b.split("\t")[:6], (a, b)


@pytest.mark.parametrize("engine", ENGINES)
def test_device_engine_multi_replicate_fisher(tmp_path, engine):
    oracle.random_sam(str(tmp_path / "in.sam"), seed=81)
    oracle.random_sam(str(tmp_path / "b.sam"), seed=82, n_pairs=250)
    _env()
    reps = f"{tmp_path / 'in.sam'},{tmp_path / 'b.sam'}"

    def run(name, extra):
        d = tmp_path / name
        d.mkdir()
        r = oracle.run_ours(["-t", reps, "-o", "out.np", "-y", "-p",
                             "0.01", "-a", "20"] + extra, cwd=str(d))
        assert r.returncode == 0, r.stderr[-1500:]
        return (d / "out.np").read_text().splitlines()

    exact = run("exact2", [])
    fast = run(f"{engine}2", ["--engine", engine])
    assert len(exact) == len(fast)
    same = sum(a.split("\t")[:6] == b.split("\t")[:6]
               for a, b in zip(exact, fast))
    assert same >= len(exact) * 0.9
    for a, b in zip(exact, fast):
        fa, fb = a.split("\t"), b.split("\t")
        for i in (6, 7):
            x, y = float(fa[i]), float(fb[i])
            assert abs(x - y) <= 1e-3 * max(1.0, abs(x)), (a, b)


@pytest.mark.parametrize("engine", ENGINES)
def test_device_engine_with_ctrl_and_exclusions(tmp_path, engine):
    oracle.random_sam(str(tmp_path / "in.sam"), seed=72)
    oracle.random_sam(str(tmp_path / "c.sam"), seed=73,
                      cluster=False, n_pairs=150)
    (tmp_path / "x.bed").write_text("chr1\t2000\t9000\n")
    _env()
    extra = ["-c", str(tmp_path / "c.sam"), "-E",
             str(tmp_path / "x.bed"), "-q", "0.5"]
    exact = _run(tmp_path, "exact", extra)
    fast = _run(tmp_path, engine, extra + ["--engine", engine])
    # Threshold-aware comparison: float32 device stats may flip
    # significance only for intervals within eps of the -log10(0.5)
    # cutoff, so any unmatched peak must be threshold-marginal (its
    # summit q within eps, or it borders a matched peak split/joined
    # at a marginal gap interval).  Matched peaks must agree exactly
    # on coordinates.
    key = lambda ln: tuple(ln.split("\t")[:3])     # noqa: E731
    ek = {key(ln): ln for ln in exact}
    fk = {key(ln): ln for ln in fast}
    eps = 0.02
    thresh = 0.30103     # -log10(0.5)

    def spans(lines):
        return [(f[0], int(f[1]), int(f[2]), float(f[8]))
                for f in (ln.split("\t") for ln in lines)]

    def check_only(only_keys, src, other_spans):
        for k in only_keys:
            f = src[k].split("\t")
            chrom, s, e, q = f[0], int(f[1]), int(f[2]), float(f[8])
            overlaps = any(c == chrom and s < oe and os_ < e
                           for c, os_, oe, _ in other_spans)
            if overlaps:
                continue    # same peak, a marginal edge interval moved
            assert abs(q - thresh) <= eps, (k, src[k])

    check_only(ek.keys() - fk.keys(), ek, spans(fast))
    check_only(fk.keys() - ek.keys(), fk, spans(exact))
    assert len(ek.keys() & fk.keys()) >= len(exact) * 0.95


@pytest.mark.parametrize("engine", ENGINES)
def test_device_engine_logs(tmp_path, engine):
    """-f/-k logs through the device RLE pullback path."""
    oracle.random_sam(str(tmp_path / "in.sam"), seed=91)
    _env()
    exact = _run(tmp_path, "exact", ["-f", "f.log", "-k", "k.log"])
    fast = _run(tmp_path, engine,
                ["-f", "f.log", "-k", "k.log", "--engine", engine])
    assert [a.split("\t")[:6] for a in exact] \
        == [b.split("\t")[:6] for b in fast]

    def rows(p):
        return [ln.split("\t") for ln in
                p.read_text().splitlines() if not ln.startswith("#")
                and not ln.startswith("chr\t")]

    fe = rows(tmp_path / "exact" / "f.log")
    ff = rows(tmp_path / engine / "f.log")
    # device logs coalesce intervals by p-value runs: every device row
    # boundary must exist in the exact log with matching values
    fe_map = {}
    for r in fe:
        fe_map[(r[0], r[2])] = r
    missing = [r for r in ff if (r[0], r[2]) not in fe_map]
    assert not missing, missing[:3]
    for r in ff:
        e = fe_map[(r[0], r[2])]
        for col in (3, 4, 5):
            x, y = float(e[col]), float(r[col])
            assert abs(x - y) <= 1e-3 * max(1.0, abs(x)), (e, r)
    # total covered bp agrees
    def span(rs):
        return sum(int(r[2]) - int(r[1]) for r in rs)
    assert span(fe) == span(ff)


@pytest.mark.parametrize("engine", ENGINES)
def test_device_engine_big_chrom_host_fallback(tmp_path, engine):
    """A chromosome with a >2^31-bp @SQ header no longer kills the
    device engines: it routes through the exact host engine
    (engine/host_fallback.py) while other chromosomes stay on
    device, and all three engines agree — including read positions
    above 2^31 and the merged genome-wide BH table."""
    big = 3_000_000_000              # > 2^31-1 = 2147483647
    oracle.random_sam(str(tmp_path / "in.sam"),
                      chroms=(("chrBig", big), ("chr2", 50000)),
                      seed=101, n_pairs=400)
    _env()
    extra = ["-q", "0.5"]
    exact = _run(tmp_path, "exact", extra)
    fast = _run(tmp_path, engine, extra + ["--engine", engine])
    assert exact, "fixture must produce peaks"
    assert any(ln.startswith("chrBig\t") for ln in exact)
    assert len(exact) == len(fast)
    for a, b in zip(exact, fast):
        fa, fb = a.split("\t"), b.split("\t")
        assert fa[:6] == fb[:6], (a, b)
        for i in (6, 7, 8):
            x, y = float(fa[i]), float(fb[i])
            assert abs(x - y) <= 1e-4 * max(1.0, abs(x)), (a, b)
    # positions above 2^31 actually exercised
    assert any(int(ln.split("\t")[1]) > 0x7FFFFFFF for ln in exact
               if ln.startswith("chrBig\t"))


def test_jax_engine_long_fragment_upload_path():
    """Fragments >= 2^16 bp fall back to the int32-ends upload
    (lengths no longer fit the uint16 wire format); coverage math
    must be unaffected."""
    import numpy as np
    _env()
    from genrich_tpu.engine.jax_bridge import JaxEngine
    eng = JaxEngine()
    ev = (np.array([100, 5000], np.int64),
          np.array([200000, 5100], np.int64),
          np.array([1, 1], np.int64))
    h = eng.coverage_chrom(0, ev, None, [], 1 << 20)
    frag, cfrag = eng.coverage_finish([h])
    # sum(len * coverage) over the two fragments
    assert abs(frag - ((200000 - 100) + 100)) < 1e-3
    assert cfrag == 0.0
    eng.release()
