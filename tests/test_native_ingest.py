"""Native C++ ingest vs pure-Python ingest: byte-equal outputs."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
import oracle  # noqa: E402

from genrich_tpu.ingest import native  # noqa: E402

pytestmark = pytest.mark.usefixtures("native_lib")


def _both(tmp_path, flags, outputs):
    d1 = tmp_path / "nat"
    d2 = tmp_path / "py"
    d1.mkdir()
    d2.mkdir()
    r1 = oracle.run_ours(flags + ["--ingest", "native"], cwd=str(d1))
    r2 = oracle.run_ours(flags + ["--ingest", "python"], cwd=str(d2))
    assert r1.returncode == r2.returncode, (r1.stderr[-1500:],
                                            r2.stderr[-1500:])
    assert r1.stderr == r2.stderr
    for name in outputs:
        assert (d1 / name).exists() == (d2 / name).exists(), name
        if (d1 / name).exists():
            assert (d1 / name).read_bytes() == \
                (d2 / name).read_bytes(), name


OUT = ["-o", "out.np", "-f", "out.log", "-k", "out.pile", "-b",
       "out.bed", "-v"]
NAMES = ("out.np", "out.log", "out.pile", "out.bed")


def test_backends_agree_basic(tmp_path):
    sam = str(tmp_path / "in.sam")
    oracle.random_sam(sam, seed=51)
    _both(tmp_path, ["-t", sam, "-y", "-q", "0.5"] + OUT, NAMES)


def test_backends_agree_dedup_atac(tmp_path):
    sam = str(tmp_path / "in.sam")
    oracle.random_sam(sam, seed=52)
    _both(tmp_path,
          ["-t", sam, "-j", "-x", "-r", "-R", "out.dups"] + OUT,
          NAMES + ("out.dups",))


def test_backends_agree_bam_ctrl(tmp_path):
    sam = str(tmp_path / "in.sam")
    ctrl = str(tmp_path / "ctrl.sam")
    oracle.random_sam(sam, seed=53)
    oracle.random_sam(ctrl, seed=54, cluster=False, n_pairs=150)
    bam = str(tmp_path / "in.bam")
    oracle.sam_to_bam(sam, bam)
    _both(tmp_path, ["-t", bam, "-c", ctrl, "-y", "-w", "140"] + OUT,
          NAMES)


def test_backends_agree_errors(tmp_path):
    sam = str(tmp_path / "in.sam")
    oracle.random_sam(sam, seed=55)
    bad = str(tmp_path / "bad.sam")
    with open(sam) as f, open(bad, "w") as g:
        for i, line in enumerate(f):
            if not line.startswith("@") and "50M" in line:
                line = line.replace("50M", "50Q", 1)
            g.write(line)
    r1 = oracle.run_ours(["-t", bad, "-o", "o.np", "--ingest",
                          "native"], cwd=str(tmp_path))
    r2 = oracle.run_ours(["-t", bad, "-o", "o.np", "--ingest",
                          "python"], cwd=str(tmp_path))
    assert r1.returncode == r2.returncode == 1
    assert r1.stderr == r2.stderr


def test_backends_agree_many_chroms_dedup(tmp_path):
    """>32767 chromosomes: the dedup scatter path (int16 chrom in its
    24-byte work record) must fall back to the permutation loop —
    exercise that fallback against the Python ingest, with -r dup
    pairs and multimappers spread across high-index chromosomes."""
    n_chroms = 33000
    chroms = [(f"c{i}", 5000) for i in range(n_chroms)]
    b = oracle.SamBuilder(chroms, seed=77)
    rng = b.rng
    for i in range(120):
        c = f"c{rng.randrange(n_chroms)}"
        p1 = rng.randrange(0, 3000)
        p2 = p1 + rng.randrange(100, 800)
        b.add_pair(c, p1, p2)
        if i % 3 == 0:          # exact duplicate: same 5' coordinates
            b.add_pair(c, p1, p2)
    # multimappers: same qname, equal-score alignments on two distant
    # chromosomes (1/N weighting + multi-key dup probing in the
    # fallback loop)
    for i in range(10):
        p = 100 + 7 * i
        q = b.add_pair("c32900", p, p + 300, score=0)
        b.add_pair(f"c{200 + i}", p, p + 300, score=0,
                   secondary=True, qname=q)
    sam = str(tmp_path / "many.sam")
    b.write(sam)
    _both(tmp_path, ["-t", sam, "-r", "-R", "out.dups", "-a", "2",
                     "-p", "0.5"] + OUT, NAMES + ("out.dups",))


def test_pair_index_tab_matches_numpy():
    """gi_pair_index_tab must reproduce numpy's searchsorted row
    mapping and diff/bincount BH lengths exactly (the p-value stage
    uses whichever is available; both must be one implementation of
    savePval + hashPval, Genrich.c:1720-1794, 300-327)."""
    import numpy as np
    from genrich_tpu.ingest import native

    rng = np.random.default_rng(5)
    for n, d in ((1, 1), (17, 3), (4096, 1), (100_000, 257),
                 (100_000, 4095)):
        uk_pool = rng.choice(np.arange(1, 1 << 62, (1 << 62) //
                                       (4 * d), dtype=np.uint64),
                             size=d, replace=False).astype(np.uint64)
        keys = rng.choice(uk_pool, size=n).astype(np.uint64)
        uk = np.unique(keys)
        ends = np.cumsum(rng.integers(1, 1000, n).astype(np.int64))
        out = native.pair_index_tab(keys, uk, ends)
        if out is None:
            import pytest
            pytest.skip("native library unavailable")
        idx, bp = out
        ref_idx = np.searchsorted(uk, keys)
        lens = np.diff(ends, prepend=np.int64(0))
        ref_bp = np.bincount(ref_idx, weights=lens.astype(np.float64),
                             minlength=len(uk))
        assert (idx == ref_idx).all()
        assert (bp == ref_bp).all()

    # a key absent from uk must refuse (numpy fallback), not corrupt
    keys = np.array([5, 9], np.uint64)
    uk = np.array([5], np.uint64)
    ends = np.array([10, 20], np.int64)
    out = native.pair_index_tab(keys, uk, ends)
    assert out is None
