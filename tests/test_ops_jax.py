"""Device-kernel tests: JAX ops vs the exact numpy engine."""

from __future__ import annotations

import numpy as np
import pytest

import conftest  # noqa: F401  (forces cpu before jax import)
import jax
import jax.numpy as jnp

from genrich_tpu.engine import pileup as epileup
from genrich_tpu.engine import pvalue as epvalue
from genrich_tpu.ops import pileup_jax, pvalue_jax
from genrich_tpu.ops.pipeline_jax import analyze_tile, random_events
from genrich_tpu.parallel import mesh as pmesh


def _random_event_set(rng, n, length, counts=(1, 2, 3, 4, 5, 6, 8, 10)):
    start = rng.randint(0, length - 1, n).astype(np.int64)
    end = start + rng.randint(1, 500, n)
    end = np.minimum(end, length)
    count = rng.choice(counts, n).astype(np.int64)
    return start, end, count


def test_canon_value_matches_engine():
    rng = np.random.RandomState(0)
    cum = np.stack([rng.randint(0, 50, 1000),
                    rng.randint(0, 200, 1000),
                    rng.randint(0, 200, 1000),
                    rng.randint(0, 200, 1000)], axis=-1)
    ours = np.asarray(pileup_jax.canon_value(jnp.asarray(cum)))
    ref = epileup.canon_value_f32(cum[:, 0].astype(np.int64),
                                  cum[:, 1].astype(np.int64),
                                  cum[:, 2].astype(np.int64),
                                  cum[:, 3].astype(np.int64))
    np.testing.assert_array_equal(ours, ref)


def test_interval_values_match_engine_rle():
    rng = np.random.RandomState(1)
    length = 100000
    start, end, count = _random_event_set(rng, 400, length)
    # engine RLE (no exclusions)
    pu, _ = epileup.expt_pileup(start, end, count, length, [])
    # device: evaluate coverage at midpoints of engine intervals
    from genrich_tpu.ops.pipeline_jax import build_event_points
    pos, deltas = build_event_points(
        jnp.asarray(start, jnp.int32), jnp.asarray(end, jnp.int32),
        jnp.asarray(count, jnp.int32))
    pos, deltas = pileup_jax.sort_events(pos, deltas)
    s_, e_, v_ = pileup_jax.interval_values(pos, deltas,
                                            jnp.int32(length))
    s_, e_, v_ = (np.asarray(x) for x in (s_, e_, v_))
    # for each engine interval, the device value over it must agree
    starts_ref = np.concatenate([[0], pu.end[:-1]])
    for j in rng.choice(len(pu.end), 50, replace=False):
        mid = (starts_ref[j] + pu.end[j]) // 2
        k = np.searchsorted(s_, mid, side="right") - 1
        if k >= 0 and s_[k] < e_[k]:
            assert v_[k] == pu.cov[j], (mid, v_[k], pu.cov[j])


def test_pvalue_f32_close_to_exact():
    rng = np.random.RandomState(2)
    expt = rng.uniform(0.0, 50.0, 2000).astype(np.float32)
    ctrl = rng.uniform(0.01, 20.0, 2000).astype(np.float32)
    exact = epvalue.calc_pval(expt, ctrl)
    fast = np.asarray(pvalue_jax.calc_pval(jnp.asarray(expt),
                                           jnp.asarray(ctrl)))
    sel = exact < 1e30
    np.testing.assert_allclose(fast[sel], exact[sel], rtol=2e-4,
                               atol=2e-4)


def test_pvalue_f64_matches_exact_bitwise():
    rng = np.random.RandomState(3)
    expt = rng.uniform(0.0, 50.0, 500).astype(np.float32)
    ctrl = rng.uniform(0.01, 20.0, 500).astype(np.float32)
    exact = epvalue.pnorm_upper_log(
        (np.log(np.maximum(expt.astype(np.float64), 1e-30)))
        .astype(np.float64))
    jax.config.update("jax_enable_x64", True)
    try:
        fast = np.asarray(pvalue_jax.pnorm_upper_log(
            jnp.log(jnp.maximum(
                jnp.asarray(expt, jnp.float64), 1e-30))))
    finally:
        jax.config.update("jax_enable_x64", False)
    np.testing.assert_allclose(fast, exact, rtol=1e-12)


def test_single_vs_sharded_peaks():
    key = jax.random.PRNGKey(0)
    length = 1_000_000
    s, e, c = random_events(key, 5000, length)
    lam = 1.1964360475540161
    res = analyze_tile(s, e, c, jnp.int32(length), jnp.float32(lam),
                       jnp.float32(2.0), jnp.float32(20.0), 0, 100)
    v = np.asarray(res.peaks.valid)
    single = sorted(
        (int(a), int(b)) for a, b in
        zip(np.asarray(res.peaks.start)[v],
            np.asarray(res.peaks.end)[v]))

    m = pmesh.make_mesh()
    T = len(m.devices.ravel())
    L = length // T
    ts, te, tc = pmesh.split_events_to_tiles(
        np.asarray(s), np.asarray(e), np.asarray(c), T, L)
    res8, lam8 = pmesh.sharded_analyze(
        m, jnp.asarray(ts), jnp.asarray(te), jnp.asarray(tc), L,
        length, 2.0, 20.0, 0, 100)
    vv = np.asarray(res8.peaks.valid)
    shard = sorted(
        (int(res8.peaks.start[t, i]) + t * L,
         int(res8.peaks.end[t, i]) + t * L)
        for t in range(T) for i in np.flatnonzero(vv[t]))
    assert abs(float(lam8) - lam) < 1e-6
    assert single == shard


def test_graft_entry_compiles():
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert int(np.asarray(out.n_intervals)) > 0


def test_dryrun_multichip():
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_excluded_mask_large_table_sort_fallback():
    """_excluded switches to the one-sort searchsorted formulation
    above 1024 table entries; both methods must agree with a numpy
    reference on boundary-inclusive semantics."""
    import numpy as np
    import jax.numpy as jnp
    from genrich_tpu.ops.pipeline_jax import _excluded
    rng = np.random.RandomState(3)
    for pairs in (16, 700):          # compare_all path and sort path
        bounds = np.sort(rng.choice(1 << 20, 2 * pairs,
                                    replace=False)).astype(np.int32)
        excl = bounds.reshape(-1, 2)
        starts = rng.randint(0, 1 << 20, 4096).astype(np.int32)
        # reference: inside some [s, e) -- searchsorted right parity
        idx = np.searchsorted(bounds, starts, side="right")
        want = (idx % 2) == 1
        got = np.asarray(_excluded(jnp.asarray(starts),
                                   jnp.asarray(excl)))
        assert (got == want).all()
        # force the sort path regardless of size (pad the table)
        pad = np.full((1200 - pairs, 2), 1 << 20, np.int32)
        excl_big = np.concatenate([excl, pad])
        idx2 = np.searchsorted(excl_big.reshape(-1), starts,
                               side="right")
        want2 = (idx2 % 2) == 1
        got2 = np.asarray(_excluded(jnp.asarray(starts),
                                    jnp.asarray(excl_big)))
        assert (got2 == want2).all()


def test_peak_auc_exact_after_large_running_total():
    """A small peak late in a tile whose earlier peaks sum to ~1e7:
    its device AUC must match the reference's per-peak float32 sum
    (a difference of whole-tile cumulative sums is off by units)."""
    from genrich_tpu.engine.peaks import call_peaks_chrom
    from genrich_tpu.ops.peaks_jax import call_peaks

    n_big = 2000
    # big peaks: one 1000-bp interval at stat 12 (AUC 1e4), each
    # followed by a 1000-bp gap interval below the threshold; then a
    # small peak of AUC 25.25 at the end
    stat = np.tile(np.array([12.0, 0.5], np.float32), n_big)
    lens = np.full(2 * n_big, 1000, np.int64)
    stat = np.concatenate([stat, np.float32([2.0 + 25.25 / 101])])
    lens = np.concatenate([lens, [101]])
    ends = np.cumsum(lens)
    starts = ends - lens
    min_pq, min_auc = np.float32(2.0), np.float32(20.0)
    want = call_peaks_chrom(stat, stat, None, ends, min_pq, min_auc,
                            0, 100)
    got = jax.jit(call_peaks, static_argnames=("min_len", "max_gap",
                                               "k_peaks"))(
        jnp.asarray(starts, jnp.int32), jnp.asarray(ends, jnp.int32),
        jnp.asarray(stat), jnp.asarray(stat),
        jnp.full(len(stat), -1.0, jnp.float32),
        jnp.ones(len(stat), bool), min_pq, min_auc, min_len=0,
        max_gap=100, k_peaks=4096)
    ok = np.asarray(got.valid)
    assert np.asarray(got.start)[ok].tolist() == [p.start for p in want]
    np.testing.assert_array_equal(np.asarray(got.auc)[ok],
                                  np.array([p.auc for p in want],
                                           np.float32))
