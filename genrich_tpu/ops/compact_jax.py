"""Device-side compaction: keep dense interval data on the device and
ship only live rows to the host.

The per-interval arrays produced by the sort-based pileup
(ops/pileup_jax.py) are many times larger than the runs, distinct
p-value tables and peaks the host needs, so they are compacted on the
device first.  All reductions here are sort-based (`lax.sort` with the
row index or the value as key), with no scatters.

The reference has no equivalent (it is a single-address-space C
program); these ops replace the role of its run-length-encoded Pileup
struct (Genrich.h:173-176) at the device/host boundary.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_BIG = np.int32(2**31 - 1)
SKIP = np.float32(-1.0)


def compact(mask, arrays):
    """Pack rows where ``mask`` to the front, preserving order.

    Returns (packed arrays tuple, live count).  One `lax.sort` with the
    original row index as key; padding rows sort to the back.
    """
    n = mask.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    key = jnp.where(mask, idx, _BIG)
    out = jax.lax.sort((key,) + tuple(arrays), num_keys=1,
                       is_stable=False)
    return out[1:], jnp.sum(mask.astype(jnp.int32))


def rle_runs(starts, ends, pv, ev, cr, excluded, live, lam, factor):
    """Coalesce equal adjacent p-values into RLE runs, on device.

    Replicates the host post-processing of the old jax bridge (drop
    zero-length intervals, break runs where -log10 p changes, record
    the boundary row's expt/ctrl values) so that only the compact runs
    cross the link.  Value semantics follow savePileupCtrl/savePval
    (Genrich.c:2052-2161, 1720-1794): ctrl = max(factor*raw, lambda),
    SKIP inside exclusions; expt = 0 inside exclusions.

    Returns (run_ends, run_pv, run_expt, run_ctrl, n_runs).
    """
    real = live & (ends > starts)
    (e_p, pv_p, ev_p, cr_p, ex_p), r = compact(
        real, (ends, pv, ev, cr, excluded.astype(jnp.int32)))
    n = e_p.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    nxt_diff = jnp.concatenate([pv_p[1:] != pv_p[:-1],
                                jnp.ones((1,), bool)])
    last = (idx < r) & (nxt_diff | (idx == r - 1))
    ctrl_v = jnp.where(ex_p != 0, SKIP,
                       jnp.maximum(factor * cr_p, lam))
    expt_v = jnp.where(ex_p != 0, jnp.float32(0.0), ev_p)
    (e_b, pv_b, ev_b, cv_b), b = compact(
        last, (e_p, pv_p, expt_v, ctrl_v))
    return e_b, pv_b, ev_b, cv_b, b


def rle_pv(starts, ends, pv, live, chrom_len):
    """p-value-only RLE coalescing with sentinel padding.

    Like rle_runs but carrying just (end, pv); rows beyond the run
    count are overwritten with (chrom_len, SKIP) so downstream n-way
    merges (Fisher combination across replicates) can treat the padded
    tail as inert.  Returns (run_ends, run_pv, n_runs).
    """
    real = live & (ends > starts)
    (e_p, pv_p), r = compact(real, (ends, pv))
    n = e_p.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    nxt_diff = jnp.concatenate([pv_p[1:] != pv_p[:-1],
                                jnp.ones((1,), bool)])
    last = (idx < r) & (nxt_diff | (idx == r - 1))
    (e_b, pv_b), b = compact(last, (e_p, pv_p))
    valid = idx < b
    e_b = jnp.where(valid, e_b, chrom_len)
    pv_b = jnp.where(valid, pv_b, SKIP)
    return e_b, pv_b, b


def merge_fisher(ends_list, pv_list):
    """n-way merge of replicate p-value RLEs + Fisher combination.

    The device analog of combinePval/multPval (Genrich.c:567-667):
    merged breakpoints are the union of every replicate's interval
    ends; each replicate contributes its value over each merged
    interval (SKIP excluded per interval, df = 2 * live replicates).
    Padding rows (end == chrom_len, pv SKIP) merge into zero-length
    dead intervals.  Returns (starts, ends, combined_pv, live).
    """
    from .chisq_jax import fisher_combine
    all_e = jnp.sort(jnp.concatenate(list(ends_list)))
    vs = []
    for e_r, p_r in zip(ends_list, pv_list):
        idx = jnp.clip(jnp.searchsorted(e_r, all_e, side="left",
                                        method="sort"),
                       0, e_r.shape[0] - 1)
        vs.append(p_r[idx])
    comb = fisher_combine(jnp.stack(vs)).astype(jnp.float32)
    starts = jnp.concatenate([jnp.zeros((1,), all_e.dtype),
                              all_e[:-1]])
    live = all_e > starts
    return starts, all_e, comb, live


def distinct_pvals(starts, ends, pv, live):
    """Distinct -log10 p values with summed bp lengths, on device.

    The device analog of hashPval/collectPval (Genrich.c:277-347):
    sort intervals by p-value, segment the equal-value runs, and
    return (p ascending, int32 bp per p, count).  SKIP intervals and
    zero-length padding carry zero weight and sort to +inf.  Lengths
    are exact in int32 (per-chrom sums are bounded by chromosome
    length < 2^31).
    """
    lens = ends - starts
    real = live & (lens > 0) & (pv != SKIP)
    key = jnp.where(real, pv, jnp.float32(np.inf))
    w = jnp.where(real, lens, 0).astype(jnp.int32)
    key_s, w_s = jax.lax.sort((key, w), num_keys=1, is_stable=False)
    cum = jnp.cumsum(w_s)
    is_last = jnp.concatenate([key_s[1:] != key_s[:-1],
                               jnp.ones((1,), bool)])
    # bp of this run = cum at run end minus cum at previous run end
    prev = jnp.concatenate([
        jnp.zeros((1,), cum.dtype),
        jax.lax.cummax(jnp.where(is_last, cum, 0))[:-1]])
    run_w = cum - prev
    keep = is_last & jnp.isfinite(key_s)
    (pv_d, w_d), d = compact(keep, (key_s, run_w))
    return pv_d, w_d, d


def distinct_pvals_k(starts, ends, pv, live, k: int):
    """distinct_pvals with a static-width [k] result (shard exchange).

    Flattened shard inputs in, fixed-shape (p, bp, count) out so the
    table can ride a fixed-size ``all_gather`` across shards.  The
    caller must check count <= k on the host (distinct coverage values
    are fraction-quantized, so thousands suffice; overflow means
    re-running with a wider k, never silent loss).  The result is
    exactly [k] wide — padded with (+inf, 0) when the shard has fewer
    than k interval rows — so fixed-stride shard exchanges line up.
    """
    pv_d, w_d, d = distinct_pvals(starts, ends, pv, live)
    n = pv_d.shape[0]
    if n >= k:
        return pv_d[:k], w_d[:k], d
    pad = k - n
    pv_d = jnp.concatenate([pv_d, jnp.full((pad,), jnp.inf,
                                           pv_d.dtype)])
    w_d = jnp.concatenate([w_d, jnp.zeros((pad,), w_d.dtype)])
    return pv_d, w_d, d


def assign_qvals(pv, table_p, table_q):
    """Per-interval q from the (ascending p -> q) lookup table.

    saveQval's per-interval binary search (Genrich.c:196-206); SKIP
    p-values keep SKIP.  ``table_p`` is padded with +inf.
    """
    # method="sort": one fused sort of queries+table instead of the
    # default binary-search scan's log2(table) serial gather passes
    # over a multi-million-row query vector (see
    # pipeline_jax._excluded)
    idx = jnp.searchsorted(table_p, pv, method="sort")
    idx = jnp.clip(idx, 0, table_p.shape[0] - 1)
    q = table_q[idx]
    return jnp.where(pv == SKIP, SKIP, q)
