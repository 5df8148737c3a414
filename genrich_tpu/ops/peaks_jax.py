"""Device peak calling: vectorized gap-join over significance runs.

Reformulates the sequential state machine (callPeaks, Genrich.c:
977-1069) as masked scans: each significant interval links to the
previous one iff the gap is within maxGap and no SKIP interval lies
between (SKIP hard-breaks); connected components become peaks.

Peak ids are non-decreasing along the interval axis, so every
per-peak reduction is a *segmented scan* (associative_scan with a
reset flag) or a plain cumulative scan plus a boundary gather —
no scatters.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

import numpy as np

_BIG = np.int32(2**31 - 1)
SKIP = np.float32(-1.0)


def _segmented_cumsum(x, reset):
    """Inclusive cumulative sum of ``x`` restarting at every row where
    ``reset`` is set.

    A peak's AUC read as the difference of two whole-tile cumulative
    sums carries the rounding error of the tile's running total (a few
    units once it passes ~1e6 in float32); restarting at each peak
    keeps the error relative to the peak's own AUC, like the
    reference's per-peak accumulation."""
    def op(a, b):
        return jnp.where(b[1], b[0], a[0] + b[0]), a[1] | b[1]
    return jax.lax.associative_scan(op, (x, reset))[0]


class TilePeaks(NamedTuple):
    start: jnp.ndarray      # int32 [M]
    end: jnp.ndarray        # int32 [M]
    auc: jnp.ndarray        # f32 [M]
    summit_pval: jnp.ndarray
    summit_qval: jnp.ndarray
    summit_pos: jnp.ndarray  # int32 [M]
    valid: jnp.ndarray      # bool [M]: candidate passing minAUC/minLen
    cand: jnp.ndarray       # bool [M]: candidate before the filters
    summit_stat: jnp.ndarray  # f32 [M]: max statistic (for merging)
    summit_len: jnp.ndarray   # int32 [M]: its interval length
    skip_head: jnp.ndarray    # bool []: SKIP before the first site
    skip_tail: jnp.ndarray    # bool []: SKIP after the last site
    n_peaks: jnp.ndarray      # int32 []: total candidates (cap check)


def call_peaks(starts, ends, stat, pval, qval, live, min_pq, min_auc,
               min_len, max_gap, k_peaks: int = 4096) -> TilePeaks:
    """Peak calling over one tile's intervals (padded to M).

    live masks real intervals; zero-length intervals are ignored.
    Returns up to ``k_peaks`` peaks per tile (top-k compacted so the
    per-peak gathers are K-wide, not M-wide); ``valid``/``cand`` mask
    real peaks.  Peaks beyond k_peaks are dropped (a 16 Mbp tile
    yields a few hundred in practice).
    """
    m = starts.shape[0]
    idx = jnp.arange(m, dtype=jnp.int32)
    lens = ends - starts
    live = live & (lens > 0)
    sig = live & (stat > min_pq)
    skp = live & (stat == SKIP)

    # previous significant interval's end / skip-count at it
    neg = jnp.int32(-1)
    prev_end_inc = jax.lax.cummax(jnp.where(sig, ends, neg))
    prev_end = jnp.concatenate([jnp.full((1,), neg), prev_end_inc[:-1]])
    has_prev = prev_end >= 0

    skip_cum = jnp.cumsum(skp.astype(jnp.int32))
    prev_sc_inc = jax.lax.cummax(jnp.where(sig, skip_cum, neg))
    prev_sc = jnp.concatenate([jnp.full((1,), neg), prev_sc_inc[:-1]])

    join = (sig & has_prev & (starts - prev_end <= max_gap)
            & (skip_cum - prev_sc == 0))
    new_peak = sig & ~join
    pid = jnp.cumsum(new_peak.astype(jnp.int32)) - 1   # non-decreasing

    # Each peak's record lives at the LAST interval of its id segment;
    # top-k compaction selects those boundary rows so every per-peak
    # gather is K-wide.  Full-width work is limited to scans and two
    # lexicographic sorts — no scatters, no binary searches.
    is_last = jnp.concatenate([pid[:-1] != pid[1:],
                               jnp.ones((1,), bool)])
    exists_row = is_last & (pid >= 0)

    contrib = jnp.where(sig, lens.astype(jnp.float32)
                        * (stat - min_pq), 0.0)
    peak_sum = _segmented_cumsum(contrib, new_peak)
    first_idx = jax.lax.cummax(jnp.where(new_peak, idx, neg))
    lastsig_inc = jax.lax.cummax(jnp.where(sig, idx, neg))

    # summit via lexicographic sorts: pid is the primary key (and
    # already sorted), so each peak keeps its contiguous index range;
    # the range's last row holds (max stat, longest, earliest) — the
    # summit *position* (updatePeak ties: longer interval replaces,
    # Genrich.c:958-964).  The summit p/q columns instead come from
    # the FIRST max-stat interval (they only update on a strict
    # stat improvement, Genrich.c:948-957), hence the second sort.
    stat_m = jnp.where(sig, stat, -jnp.inf)
    _, bstat, _, _, bpos = jax.lax.sort(
        (pid, stat_m, jnp.where(sig, lens, -_BIG), -idx, idx),
        num_keys=4)
    _, _, _, bpos_first = jax.lax.sort((pid, stat_m, -idx, idx),
                                       num_keys=3)

    # compact the boundary rows (ascending original order -> take the
    # k largest row indices, then reverse)
    k = min(k_peaks, m)
    score = jnp.where(exists_row, idx, jnp.int32(-1))
    top, rows = jax.lax.top_k(score, k)
    rows = jnp.clip(rows[::-1], 0, m - 1)
    exists = top[::-1] >= 0

    fi = jnp.clip(first_idx[rows], 0, m - 1)
    auc = peak_sum[rows]
    p_start = starts[fi]
    p_end = ends[jnp.clip(lastsig_inc[rows], 0, m - 1)]

    max_stat = bstat[rows]
    pi = jnp.clip(bpos[rows], 0, m - 1)
    pf = jnp.clip(bpos_first[rows], 0, m - 1)
    summit_pval = pval[pf]
    summit_qval = qval[pf]
    summit_pos = (starts[pi] + ends[pi]) // 2 - p_start
    summit_len = lens[pi]

    valid = (exists & (auc >= min_auc)
             & ((p_end - p_start) >= min_len))

    # boundary metadata for cross-tile merging
    any_sig = jnp.any(sig)
    first_sig = jnp.argmax(sig).astype(jnp.int32)
    last_sig = (m - 1 - jnp.argmax(sig[::-1])).astype(jnp.int32)
    skip_head = jnp.any(skp & (idx < first_sig)) & any_sig
    skip_tail = jnp.any(skp & (idx > last_sig)) & any_sig

    n_peaks = jnp.maximum(pid[-1] + 1, 0).astype(jnp.int32)
    return TilePeaks(p_start, p_end, auc, summit_pval, summit_qval,
                     summit_pos, valid, exists, max_stat, summit_len,
                     skip_head, skip_tail, n_peaks)
