"""Cross-tile peak merging: sharded + merge == single-device peaks."""

from __future__ import annotations

import numpy as np

import conftest  # noqa: F401
import jax
import jax.numpy as jnp

from genrich_tpu.ops.pipeline_jax import analyze_tile
from genrich_tpu.parallel import mesh as pmesh


def _single(start, end, count, length, lam):
    res = analyze_tile(jnp.asarray(start), jnp.asarray(end),
                       jnp.asarray(count), jnp.int32(length),
                       jnp.float32(lam), jnp.float32(2.0),
                       jnp.float32(20.0), 0, 100)
    v = np.asarray(res.peaks.valid)
    return sorted((int(a), int(b)) for a, b in
                  zip(np.asarray(res.peaks.start)[v],
                      np.asarray(res.peaks.end)[v]))


def test_boundary_straddling_peak():
    length = 8 * 4096
    L = 4096
    rng = np.random.RandomState(3)
    # background + a dense cluster straddling the tile-3/4 boundary
    n_bg = 2000
    start = rng.randint(0, length - 300, n_bg)
    cluster = rng.randint(3 * L + 3600, 4 * L + 400, 800)
    start = np.concatenate([start, cluster]).astype(np.int32)
    end = (start + rng.randint(80, 300, len(start))).astype(np.int32)
    end = np.minimum(end, length).astype(np.int32)
    count = np.ones(len(start), np.int32)

    lam = float((end - start).sum()) / length
    single = _single(start, end, count, length, lam)
    assert any(s < 4 * L < e for (s, e) in single), \
        "fixture must produce a boundary-straddling peak"

    m = pmesh.make_mesh()
    ts, te, tc = pmesh.split_events_to_tiles(start, end, count, 8, L)
    res, lam8 = pmesh.sharded_analyze(
        m, jnp.asarray(ts), jnp.asarray(te), jnp.asarray(tc), L,
        length, 2.0, 20.0, 0, 100)
    merged = pmesh.merge_tile_peaks(res, L, 20.0, 0, 100)
    got = sorted((int(s), int(e)) for (s, e, *_rest) in merged)
    assert got == single


# ---- vectorized merge == sequential reference (property test) --------

def _rand_tilepeaks(rng, n_tiles, cap, tile_len, chain=False):
    """Synthetic TilePeaks exercising joins, skips, ties, and chains."""
    from genrich_tpu.ops.peaks_jax import TilePeaks
    if chain:
        # one near-full-tile candidate per tile: long join chains that
        # stress the float32 AUC accumulation order
        cand = np.zeros((n_tiles, cap), bool)
        cand[:, 0] = rng.rand(n_tiles) < 0.95
        starts = np.zeros((n_tiles, cap), np.int32)
        ends = np.full((n_tiles, cap), 1, np.int32)
        starts[:, 0] = rng.randint(0, 60, n_tiles)
        ends[:, 0] = tile_len - rng.randint(0, 60, n_tiles)
    else:
        cand = rng.rand(n_tiles, cap) < 0.4
        starts = rng.randint(0, tile_len - 2,
                             (n_tiles, cap)).astype(np.int32)
        ends = np.minimum(
            starts + rng.randint(1, tile_len // 2, (n_tiles, cap)),
            tile_len).astype(np.int32)
    shape = (n_tiles, cap)
    auc = (rng.rand(*shape) * 50).astype(np.float32)
    spv = (rng.rand(*shape) * 10).astype(np.float32)
    sqv = (rng.rand(*shape) * 10).astype(np.float32)
    spos = rng.randint(0, tile_len, shape).astype(np.int32)
    # discrete stats/lengths so tie-break rules actually fire
    sstat = rng.choice(np.asarray([1.0, 2.0, 3.0], np.float32),
                       shape)
    slen = rng.randint(1, 4, shape).astype(np.int32)
    skip_head = rng.rand(n_tiles) < 0.2
    skip_tail = rng.rand(n_tiles) < 0.2
    return TilePeaks(starts, ends, auc, spv, sqv, spos, cand, cand,
                     sstat, slen, skip_head, skip_tail,
                     np.int32(0))


def test_merge_vectorized_equals_loop():
    from genrich_tpu.ops.pipeline_jax import TileResult
    rng = np.random.RandomState(11)
    for trial in range(12):
        chain = trial % 3 == 2
        n_tiles = int(rng.randint(1, 40))
        cap = int(rng.randint(1, 16))
        tile_len = 4096
        pk = _rand_tilepeaks(rng, n_tiles, cap, tile_len, chain)
        res = TileResult(pk, None, None)
        max_gap = int(rng.randint(0, 200))
        min_auc = float(rng.rand() * 30)
        min_len = int(rng.randint(0, 50))
        a = pmesh.merge_tile_peaks(res, tile_len, min_auc, min_len,
                                   max_gap)
        b = pmesh._merge_tile_peaks_loop(res, tile_len, min_auc,
                                         min_len, max_gap)
        assert len(a) == len(b), (trial, len(a), len(b))
        for x, y in zip(a, b):
            assert x == y, (trial, x, y)


def test_merge_dense_10k_tiles():
    """10^4 tiles with dense candidates: equality + a practical bound
    (the scenario where the Python loop becomes the
    sequential tail)."""
    import time
    from genrich_tpu.ops.pipeline_jax import TileResult
    rng = np.random.RandomState(5)
    pk = _rand_tilepeaks(rng, 10_000, 64, 1 << 16)
    res = TileResult(pk, None, None)
    t0 = time.perf_counter()
    a = pmesh.merge_tile_peaks(res, 1 << 16, 10.0, 0, 100)
    vec_s = time.perf_counter() - t0
    b = pmesh._merge_tile_peaks_loop(res, 1 << 16, 10.0, 0, 100)
    assert a == b
    assert len(a) > 1000          # the fixture is genuinely dense
    assert vec_s < 8.0, f"vectorized merge too slow: {vec_s:.2f}s"
