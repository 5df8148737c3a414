"""Fused device pipeline: fragment events -> peaks, one XLA program.

This is the device fast path for the genome-scale numeric phase: a tile's
fragment events (start, end, count-code) go through sort, cumulative
class sums, coverage reconstruction, the log-normal p-value, and
vectorized peak calling without leaving the device.  The exact
(byte-parity) path lives in genrich_tpu.engine; this path trades the
float64 tail approximations for float32 at ~1e-6 relative error on
-log10 p.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .peaks_jax import TilePeaks, call_peaks
from .pileup_jax import (canon_value, event_deltas, interval_values,
                         sort_events)
from .pvalue_jax import calc_pval


class TileResult(NamedTuple):
    peaks: TilePeaks
    frag_len: jnp.ndarray    # f32 scalar: weighted fragment length
    n_intervals: jnp.ndarray


def build_event_points(start, end, count):
    """Events -> (pos, deltas) point lists (2E points).

    count == 0 marks padding (zero deltas); padding positions should
    already be tile_len so they sort to the end.
    """
    add, sub = event_deltas(count)
    pos = jnp.concatenate([start, end])
    deltas = jnp.concatenate([add, sub], axis=0)
    return pos, deltas


def analyze_tile_core(start, end, count, tile_len, carry, lam, min_pq,
                      min_auc, min_len: int, max_gap: int) -> TileResult:
    """Tile analysis with an inter-tile carry (jit/vmap/shard_map-able).

    start/end/count: int32 [E] padded (count 0, start=end=tile_len).
    carry: int32 [4] — cumulative class sums entering this tile (the
    blockwise-scan carry for fragments spanning tile boundaries).
    lam: background rate (no-control mode); min_pq: -log10 threshold.
    """
    pos, deltas = build_event_points(start, end, count)
    # virtual point at 0 so the leading interval carries the incoming
    # coverage (nonzero when carry != 0)
    pos = jnp.concatenate([jnp.zeros((1,), pos.dtype), pos])
    deltas = jnp.concatenate([jnp.zeros((1, 4), deltas.dtype), deltas])
    pos, deltas = sort_events(pos, deltas)
    cum = jnp.cumsum(deltas, axis=0) + carry[None, :]
    vals = canon_value(cum)
    starts = pos
    ends = jnp.concatenate([pos[1:],
                            jnp.full((1,), tile_len, pos.dtype)])

    lens = (ends - starts).astype(jnp.float32)
    frag_len = jnp.sum(lens * vals)

    ctrl = jnp.full_like(vals, lam)
    pval = calc_pval(vals, ctrl)

    live = starts < tile_len
    peaks = call_peaks(starts, ends, pval, pval,
                       jnp.full_like(pval, -1.0), live,
                       min_pq, min_auc, min_len, max_gap)
    return TileResult(peaks, frag_len, jnp.sum(live.astype(jnp.int32)))


@partial(jax.jit, static_argnames=("min_len", "max_gap"))
def analyze_tile(start, end, count, tile_len, lam, min_pq, min_auc,
                 min_len: int, max_gap: int) -> TileResult:
    """Single-tile analysis (no carry): events -> peaks."""
    return analyze_tile_core(start, end, count, tile_len,
                             jnp.zeros((4,), jnp.int32), lam, min_pq,
                             min_auc, min_len, max_gap)


def tile_class_totals(start, end, count) -> jnp.ndarray:
    """Sum of all class deltas in a tile (for inter-tile carries)."""
    add, sub = event_deltas(count)
    return jnp.sum(add + sub, axis=0)


def _excluded(starts, excl):
    """True for intervals whose start lies inside a -E exclusion.

    excl: int32 [K, 2] (start, end) pairs padded with (tile_len,
    tile_len); exclusion boundaries must be among the breakpoints for
    exact interval splitting (callers add them as zero-delta points).

    The default binary-search ``scan`` makes log2(K) serial gather
    passes over the M-row query vector.  For the usual small table a
    broadcast compare-and-count does one fused pass instead; huge -E
    tables fall back to the one-sort formulation.
    """
    flat = excl.reshape(-1)
    method = "compare_all" if flat.shape[0] <= 1024 else "sort"
    idx = jnp.searchsorted(flat, starts, side="right", method=method)
    return (idx % 2) == 1


def tile_coverage(es, ee, ec, cs, ce, cc, excl, tile_len, carry_e,
                  carry_c, limit=None):
    """Events -> per-interval expt/ctrl coverage for one tile.

    Expt and ctrl events merge into one 8-channel point list and a
    single sort.  Returns (starts, ends, expt_val, ctrl_raw, excluded,
    live, frag_len, ctrl_frag); ctrl_raw is the *unscaled* control
    coverage (scaling needs the global factor, applied in tile_stats).

    ``limit`` (default tile_len) clips the tile's analyzed span: when
    a chromosome ends inside this tile of the grid, intervals past the
    chromosome end must not exist (they would otherwise contribute
    phantom bp to the BH histogram and the -f/-k logs).
    """
    if limit is None:
        limit = tile_len
    e_pos, e_del = build_event_points(es, ee, ec)
    c_pos, c_del = build_event_points(cs, ce, cc)
    zeros_e = jnp.zeros_like(e_del)
    zeros_c = jnp.zeros_like(c_del)
    # exclusion boundaries as zero-delta breakpoints
    x_pos = excl.reshape(-1)
    x_del = jnp.zeros((x_pos.shape[0], 8), jnp.int32)
    pos = jnp.concatenate([jnp.zeros((1,), e_pos.dtype), e_pos, c_pos,
                           x_pos])
    deltas = jnp.concatenate([
        jnp.zeros((1, 8), jnp.int32),
        jnp.concatenate([e_del, zeros_e], axis=1),
        jnp.concatenate([zeros_c, c_del], axis=1),
        x_del])
    from .pileup_jax import pack_deltas, unpack_deltas
    pos, packed = jax.lax.sort((pos, pack_deltas(deltas)),
                               num_keys=1, is_stable=False)
    deltas = unpack_deltas(packed, 2)
    cum = jnp.cumsum(deltas, axis=0)
    expt_val = canon_value(cum[:, :4] + carry_e[None, :])
    ctrl_raw = canon_value(cum[:, 4:] + carry_c[None, :])

    starts = pos
    ends = jnp.concatenate([pos[1:],
                            jnp.full((1,), tile_len, pos.dtype)])
    ends = jnp.minimum(ends, limit)
    excluded = _excluded(starts, excl)
    live = starts < limit
    lens = jnp.maximum(ends - starts, 0).astype(jnp.float32)
    frag_len = jnp.sum(jnp.where(excluded, 0.0, lens * expt_val))
    ctrl_frag = jnp.sum(jnp.where(excluded, 0.0, lens * ctrl_raw))
    return (starts, ends, expt_val, ctrl_raw, excluded, live,
            frag_len, ctrl_frag)


def tile_stats(expt_val, ctrl_raw, excluded, factor, lam):
    """-log10 p per interval from coverage + global factor/lambda.

    Ctrl coverage is max(factor * val, lambda); excluded intervals
    carry SKIP (hard peak breaks), matching savePileupCtrl/savePval
    semantics (Genrich.c:2052-2161, 1720-1794) in float32.
    """
    ctrl_val = jnp.maximum(factor * ctrl_raw, lam)
    ctrl_eff = jnp.where(excluded, jnp.float32(-1.0), ctrl_val)
    return calc_pval(jnp.where(excluded, 0.0, expt_val), ctrl_eff)


def analyze_tile_ctrl(es, ee, ec, cs, ce, cc, excl, tile_len,
                      carry_e, carry_c, lam, factor, min_pq, min_auc,
                      min_len: int, max_gap: int):
    """Full-feature single-tile analysis: expt + ctrl + exclusions."""
    (starts, ends, expt_val, ctrl_raw, excluded, live, frag_len,
     ctrl_frag) = tile_coverage(es, ee, ec, cs, ce, cc, excl,
                                tile_len, carry_e, carry_c)
    pval = tile_stats(expt_val, ctrl_raw, excluded, factor, lam)
    peaks = call_peaks(starts, ends, pval, pval,
                       jnp.full_like(pval, -1.0), live,
                       min_pq, min_auc, min_len, max_gap)
    return TileResult(peaks, frag_len, jnp.sum(live.astype(jnp.int32))
                      ), ctrl_frag, pval, starts, ends, live


def random_events(key, n_events: int, tile_len: int,
                  n_hotspots: int = 8, frac_hot: float = 0.7):
    """Synthetic clustered fragment events for benches and dry-runs."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    hot = jax.random.randint(k1, (n_hotspots,), 0,
                             max(1, tile_len - 2000))
    which = jax.random.randint(k2, (n_events,), 0, n_hotspots)
    is_hot = jax.random.uniform(k3, (n_events,)) < frac_hot
    base = jnp.where(
        is_hot,
        hot[which] + jax.random.randint(k4, (n_events,), 0, 1500),
        jax.random.randint(k4, (n_events,), 0,
                           max(1, tile_len - 500)))
    frag = jax.random.randint(k2, (n_events,), 80, 400)
    start = jnp.clip(base, 0, tile_len - 1).astype(jnp.int32)
    end = jnp.clip(base + frag, 1, tile_len).astype(jnp.int32)
    end = jnp.maximum(end, start + 1)
    count = jnp.ones((n_events,), jnp.int32)
    return start, end, count
