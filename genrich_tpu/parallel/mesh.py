"""Multi-device sharding of the genome-tile pipeline.

The genome is cut into fixed-length tiles; tiles shard across a 1-D
``jax.sharding.Mesh`` (axis "tiles") with ``shard_map``.  The reference
has no parallelism at all (single-threaded C, SURVEY.md §2); the
shardable structure comes from its implicit axes: per-chromosome /
per-tile data parallelism for the pileup+stats sweeps, with three
global couplings implemented as collectives:

  - total weighted fragment length -> lambda: ``psum`` over tiles
    (savePileupExpt's global accumulator, Genrich.c:2168-2295);
  - inter-tile pileup carry: per-tile class-delta totals are
    ``all_gather``-ed and prefix-summed, the blockwise-scan carry for
    fragments spanning tile boundaries;
  - peaks straddling tile boundaries: each tile emits boundary run
    info; the (tiny) cross-boundary merge happens on the host.

On several GPUs of one host the "tiles" axis spans the cards (XLA
carries psum/all_gather over NCCL); tests use a virtual 8-device CPU
mesh.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.pipeline_jax import (TileResult, analyze_tile_core,
                                tile_class_totals, tile_coverage,
                                tile_stats)

AXIS = "tiles"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            # fail loudly: silently validating a smaller mesh (e.g.
            # one GPU when 8 virtual CPU devices were intended) would
            # make multi-device checks vacuous
            raise RuntimeError(
                f"make_mesh({n_devices}): only {len(devs)} "
                f"device(s) visible on platform "
                f"'{devs[0].platform}'; set JAX_PLATFORMS=cpu and "
                f"XLA_FLAGS=--xla_force_host_platform_device_count="
                f"{n_devices} for a virtual mesh")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (AXIS,))


def _local_step(start, end, count, tile_len, genome_len, min_pq,
                min_auc, min_len, max_gap):
    """Per-shard body (runs under shard_map over the 'tiles' axis).

    start/end/count: int32 [tiles_per_dev, E] local shard, positions
    tile-local.  Returns per-tile peaks plus the global lambda.
    """
    # global weighted fragment length -> lambda (psum collective)
    add = jnp.sum((end - start).astype(jnp.float32)
                  * jnp.where(count > 0, 1.0 / jnp.maximum(count, 1),
                              0.0), axis=1)
    local_frag = jnp.sum(add)
    total_frag = jax.lax.psum(local_frag, AXIS)
    lam = total_frag / genome_len

    # inter-tile carry: all_gather per-tile class totals, exclusive
    # prefix over the global tile order
    totals = jax.vmap(tile_class_totals)(start, end, count)  # [t, 4]
    all_totals = jax.lax.all_gather(totals, AXIS)            # [D, t, 4]
    d, t, _ = all_totals.shape
    flat = all_totals.reshape(d * t, 4)
    excl = jnp.concatenate([jnp.zeros((1, 4), flat.dtype),
                            jnp.cumsum(flat, axis=0)[:-1]])
    my = jax.lax.axis_index(AXIS)
    carries = jax.lax.dynamic_slice_in_dim(excl, my * t, t)   # [t, 4]

    res = jax.vmap(
        lambda s, e, c, cr: analyze_tile_core(
            s, e, c, tile_len, cr, lam, min_pq, min_auc,
            min_len, max_gap)
    )(start, end, count, carries)
    pk = res.peaks
    return (pk.start, pk.end, pk.auc, pk.summit_pval, pk.summit_qval,
            pk.summit_pos, pk.valid, pk.cand, pk.summit_stat,
            pk.summit_len, pk.skip_head, pk.skip_tail, pk.n_peaks,
            res.frag_len, res.n_intervals, lam)


def sharded_analyze(mesh: Mesh, start, end, count, tile_len: int,
                    genome_len: int, min_pq: float, min_auc: float,
                    min_len: int = 0, max_gap: int = 100):
    """Run the tile pipeline sharded over the mesh.

    start/end/count: int32 [T, E] with T a multiple of the mesh size;
    positions are tile-local (caller splits events by tile, duplicating
    boundary-spanning fragments into both tiles' point lists).

    Returns (TileResult with [T, M] peak arrays, lambda).
    """
    from ..ops.peaks_jax import TilePeaks
    fn = jax.shard_map(
        partial(_local_step, tile_len=jnp.int32(tile_len),
                genome_len=jnp.float32(genome_len),
                min_pq=jnp.float32(min_pq),
                min_auc=jnp.float32(min_auc),
                min_len=min_len, max_gap=max_gap),
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS)),
        out_specs=tuple([P(AXIS)] * 15) + (P(),),
    )
    out = jax.jit(fn)(start, end, count)
    peaks = TilePeaks(*out[:13])
    return TileResult(peaks, out[13], out[14]), out[15]


def _excl_carry_prefix(totals, t):
    """Exclusive prefix of per-tile class totals across the mesh."""
    all_totals = jax.lax.all_gather(totals, AXIS)            # [D, t, 4]
    d = all_totals.shape[0]
    flat = all_totals.reshape(d * t, 4)
    excl = jnp.concatenate([jnp.zeros((1, 4), flat.dtype),
                            jnp.cumsum(flat, axis=0)[:-1]])
    my = jax.lax.axis_index(AXIS)
    return jax.lax.dynamic_slice_in_dim(excl, my * t, t)


class ShardedKernels:
    """Jitted shard_map steps over a tile mesh (one instance per
    (mesh, tile_len); jit caches reuse across chromosomes/replicates).

    Three-step structure with host scalars in between:

      cov:    events -> resident sharded interval arrays; per-tile
              fragment-length sums ride an ``all_gather`` so every
              process can run the float64 host accumulation -> lambda
              and the control scale factor (calcFactor,
              Genrich.c:1980-2046).
      stats:  elementwise -log10 p per interval, plus the per-shard
              distinct (p, bp) tables ``all_gather``-ed for the EXACT
              genome-wide BH: the q sweep runs on the host with the
              same float32 ops (incl. the glibc log10f quirk) as
              engine/qvalue.py, identically on every process.
      peaks:  q assignment via the replicated (p -> q) table + the
              vectorized per-tile peak caller.

    Interval arrays never leave the devices between steps; only the
    fragment scalars and the (small, fraction-quantized) distinct
    table cross to the host.
    """

    def __init__(self, mesh: Mesh, tile_len: int,
                 k_distinct: int = 1 << 13):
        self.mesh = mesh
        self.tile_len = int(tile_len)
        self.k = int(k_distinct)
        self._peaks_cache = {}
        self._fisher_cache = {}

        from ..ops.compact_jax import distinct_pvals_k

        n_dev = int(np.prod(mesh.devices.shape))

        def replicated_concat(x):
            """Shard-local [t, ...] -> replicated [D*t, ...].

            A masked psum (each shard adds its rows into its slice of
            a zero array) — bitwise exact (x + 0 == x) and, unlike
            all_gather, statically inferable as replicated by
            shard_map's vma check.
            """
            my = jax.lax.axis_index(AXIS)
            t = x.shape[0]
            out = jnp.zeros((n_dev * t,) + x.shape[1:], x.dtype)
            out = jax.lax.dynamic_update_slice_in_dim(out, x, my * t, 0)
            return jax.lax.psum(out, AXIS)

        self._replicated_concat = replicated_concat

        def cov_step(es, ee, ec, cs, ce, cc, excl, limit):
            t = es.shape[0]
            carry_e = _excl_carry_prefix(
                jax.vmap(tile_class_totals)(es, ee, ec), t)
            carry_c = _excl_carry_prefix(
                jax.vmap(tile_class_totals)(cs, ce, cc), t)
            cov = jax.vmap(
                lambda a, b, c, d2, e, f, x, ke, kc, lm: tile_coverage(
                    a, b, c, d2, e, f, x, jnp.int32(self.tile_len),
                    ke, kc, lm)
            )(es, ee, ec, cs, ce, cc, excl, carry_e, carry_c, limit)
            (starts, ends, ev, cr, excluded, live, frag, cfrag) = cov
            frag_all = replicated_concat(frag)
            cfrag_all = replicated_concat(cfrag)
            return (starts, ends, ev, cr, excluded, live, frag_all,
                    cfrag_all)

        self.cov = jax.jit(jax.shard_map(
            cov_step, mesh=mesh, in_specs=tuple([P(AXIS)] * 8),
            out_specs=tuple([P(AXIS)] * 6) + (P(), P())))

        def stats_step(ev, cr, excluded, lam, factor):
            return jax.vmap(
                lambda e, c, x: tile_stats(e, c, x, factor, lam)
            )(ev, cr, excluded)

        self.stats = jax.jit(jax.shard_map(
            stats_step, mesh=mesh,
            in_specs=tuple([P(AXIS)] * 3) + (P(), P()),
            out_specs=P(AXIS)))

        def distinct_step(starts, ends, pval, live):
            pv_k, w_k, dct = distinct_pvals_k(
                starts.reshape(-1), ends.reshape(-1),
                pval.reshape(-1), live.reshape(-1), self.k)
            pv_all = replicated_concat(pv_k)
            w_all = replicated_concat(w_k)
            d_all = replicated_concat(dct.reshape(1))
            return pv_all, w_all, d_all

        self.distinct = jax.jit(jax.shard_map(
            distinct_step, mesh=mesh,
            in_specs=tuple([P(AXIS)] * 4),
            out_specs=(P(), P(), P())))

        from ..ops.compact_jax import rle_pv, rle_runs

        def rle_step(starts, ends, pv, ev, cr, excluded, live, lam,
                     factor):
            return jax.vmap(
                lambda s, e, p, a, b, x, l: rle_runs(
                    s, e, p, a, b, x, l, lam, factor)
            )(starts, ends, pv, ev, cr, excluded, live)

        self.rle = jax.jit(jax.shard_map(
            rle_step, mesh=mesh,
            in_specs=tuple([P(AXIS)] * 7) + (P(), P()),
            out_specs=P(AXIS)))

        def rle_pv_step(starts, ends, pv, live, limit):
            return jax.vmap(rle_pv)(starts, ends, pv, live, limit)

        self.rle_pv = jax.jit(jax.shard_map(
            rle_pv_step, mesh=mesh, in_specs=tuple([P(AXIS)] * 5),
            out_specs=P(AXIS)))

    def peaks(self, use_q: bool, min_len: int, max_gap: int,
              replicated: bool = False):
        """Peak-calling step.  With ``replicated`` the (small) per-tile
        peak arrays ride a psum exchange so every process holds the
        full set — required for the host boundary merge when tiles
        span multiple processes (multi-host)."""
        key = (use_q, min_len, max_gap, replicated)
        fn = self._peaks_cache.get(key)
        if fn is not None:
            return fn
        from ..ops.compact_jax import assign_qvals
        from ..ops.peaks_jax import call_peaks

        def peaks_step(starts, ends, pval, live, tab_p, tab_q,
                       min_pq, min_auc):
            if use_q:
                stat = jax.vmap(
                    lambda v: assign_qvals(v, tab_p, tab_q))(pval)
                qv = stat
            else:
                stat = pval
                qv = jnp.full_like(pval, -1.0)
            res = jax.vmap(
                lambda s, e, st, pv, q, lv: call_peaks(
                    s, e, st, pv, q, lv, min_pq, min_auc, min_len,
                    max_gap))(starts, ends, stat, pval, qv, live)
            if replicated:
                res = jax.tree.map(self._replicated_concat, res)
            return res

        out_spec = P() if replicated else P(AXIS)
        fn = jax.jit(jax.shard_map(
            peaks_step, mesh=self.mesh,
            in_specs=tuple([P(AXIS)] * 4) + tuple([P()] * 4),
            out_specs=out_spec))
        self._peaks_cache[key] = fn
        return fn

    def fisher(self, r: int):
        """combinePval (Genrich.c:612-667) per tile across r replicate
        RLEs: args are r end arrays then r p-value arrays, [T, M_i]
        each, padded with (tile limit, SKIP) rows."""
        fn = self._fisher_cache.get(r)
        if fn is not None:
            return fn
        from ..ops.compact_jax import merge_fisher

        def fisher_step(*arrs):
            def per_tile(*xs):
                return merge_fisher(tuple(xs[:r]), tuple(xs[r:]))
            return jax.vmap(per_tile)(*arrs)

        fn = jax.jit(jax.shard_map(
            fisher_step, mesh=self.mesh,
            in_specs=tuple([P(AXIS)] * (2 * r)),
            out_specs=P(AXIS)))
        self._fisher_cache[r] = fn
        return fn


def exact_q_table(pv_gathered, w_gathered, d_gathered, k: int,
                  genome_len: int):
    """Host-side exact BH from the gathered per-shard distinct tables.

    Merges shards' (p, bp) pairs (np.unique + summed uint64 lengths)
    and runs the exact float32 q sweep (engine/qvalue.py, mirroring
    computeQval Genrich.c:352-401).  Deterministic and identical on
    every process.  Returns (tab_p, tab_q, total_bp, all_one) with
    tab_p padded to a power of two with +inf.  Raises if any shard's
    distinct count exceeded k (rerun with a wider k — never silent).
    """
    from ..engine import qvalue

    pv_g = np.asarray(pv_gathered)
    w_g = np.asarray(w_gathered)
    d_g = np.asarray(d_gathered).reshape(-1)
    if (d_g > k).any():
        raise ValueError(
            f"distinct p-value overflow: a shard saw {int(d_g.max())}"
            f" > k_distinct={k}; rebuild ShardedKernels with a wider"
            f" k_distinct")
    ps, ws = [], []
    for i, d in enumerate(d_g):
        d = int(d)
        if d:
            ps.append(pv_g[i * k:i * k + d])
            ws.append(w_g[i * k:i * k + d].astype(np.uint64))
    if not ps:
        return (np.full(1, np.inf, np.float32),
                np.zeros(1, np.float32), 0, False)
    _, _, tab_p, tab_q, total_bp, all_one = \
        qvalue.merge_distinct_tables(ps, ws, genome_len, lo=1 << 8)
    return tab_p, tab_q, total_bp, all_one


def sharded_analyze_full(mesh: Mesh, es, ee, ec, cs, ce, cc, excl,
                         tile_len: int, genome_len: int,
                         min_pq: float, min_auc: float,
                         min_len: int = 0, max_gap: int = 100,
                         qval_opt: bool = False,
                         k_distinct: int = 1 << 13,
                         limit=None, kern=None):
    """Full pipeline sharded over tiles: ctrl + exclusions + exact BH.

    All inputs [T, ...] shard over the tile axis; ``excl`` is
    [T, K, 2] per-tile exclusion intervals padded with tile_len;
    ``limit`` [T] clips each tile's analyzed span (chromosome ends).
    ``kern`` optionally reuses a ShardedKernels built for this
    (mesh, tile_len) — repeated callers (benchmarks, dryruns) would
    otherwise re-trace every jit on each call.
    Returns (TileResult, lambda, factor).
    """
    if kern is None:
        kern = ShardedKernels(mesh, tile_len, k_distinct)
    n_tiles = es.shape[0]
    if limit is None:
        limit = np.full(n_tiles, tile_len, np.int32)
    (starts, ends, ev, cr, excluded, live, frag_all,
     cfrag_all) = kern.cov(es, ee, ec, cs, ce, cc, excl,
                           jnp.asarray(limit, jnp.int32))
    frag = float(np.asarray(frag_all, np.float64).sum())
    cfrag = float(np.asarray(cfrag_all, np.float64).sum())
    lam = np.float32(frag / genome_len)
    factor = np.float32(1.0) if cfrag == 0.0 \
        else np.float32(frag / cfrag)
    pval = kern.stats(ev, cr, excluded, jnp.float32(lam),
                      jnp.float32(factor))
    if qval_opt:
        pv_all, w_all, d_all = kern.distinct(starts, ends, pval, live)
        tab_p, tab_q, _, _ = exact_q_table(pv_all, w_all, d_all,
                                           kern.k, genome_len)
    else:
        tab_p = np.full(1, np.inf, np.float32)
        tab_q = np.zeros(1, np.float32)
    peaks = kern.peaks(qval_opt, min_len, max_gap)(
        starts, ends, pval, live, jnp.asarray(tab_p),
        jnp.asarray(tab_q), jnp.float32(min_pq),
        jnp.float32(min_auc))
    return TileResult(peaks, frag_all, None), lam, factor


def merge_tile_peaks(result: TileResult, tile_len: int,
                     min_auc: float, min_len: int, max_gap: int):
    """Host-side merge of peaks straddling tile boundaries.

    Adjacent tiles' edge candidates join when the global gap is within
    maxGap and no SKIP interval separates them (the same rule the
    sequential reference applies, callPeaks Genrich.c:1026-1040).
    Assumes max_gap < tile_len so siteless tiles always break chains.
    Returns [(start, end, auc, summit_pval, summit_qval, summit_pos)].

    Fully vectorized (grouping by a join-flag cumsum + segmented
    reductions): the sequential tail of the sharded pipeline stays
    O(candidates) numpy work, not a Python loop — at 10^4 tiles with
    dense candidate caps this is ~100x the loop formulation (kept
    below as ``_merge_tile_peaks_loop``, the oracle for the property
    test in tests/test_mesh_merge.py).
    """
    assert max_gap < tile_len
    pk = result.peaks
    cand = np.asarray(pk.cand)
    n_tiles, cap = cand.shape
    t_idx, k_idx = np.nonzero(cand)
    n = len(t_idx)
    if n == 0:
        return []
    starts = np.asarray(pk.start)[t_idx, k_idx].astype(np.int64)
    ends = np.asarray(pk.end)[t_idx, k_idx].astype(np.int64)
    aucs = np.asarray(pk.auc)[t_idx, k_idx]
    spv = np.asarray(pk.summit_pval)[t_idx, k_idx]
    sqv = np.asarray(pk.summit_qval)[t_idx, k_idx]
    spos = np.asarray(pk.summit_pos)[t_idx, k_idx].astype(np.int64)
    sstat = np.asarray(pk.summit_stat)[t_idx, k_idx]
    slen = np.asarray(pk.summit_len)[t_idx, k_idx].astype(np.int64)
    skip_head = np.asarray(pk.skip_head).astype(bool).reshape(-1)
    skip_tail = np.asarray(pk.skip_tail).astype(bool).reshape(-1)

    # candidates in (tile, start, k) order — the loop's visit order
    perm = np.lexsort((k_idx, starts, t_idx))
    t_idx, starts, ends = t_idx[perm], starts[perm], ends[perm]
    aucs, spv, sqv = aucs[perm], spv[perm], sqv[perm]
    spos, sstat, slen = spos[perm], sstat[perm], slen[perm]
    g_start = starts + t_idx.astype(np.int64) * tile_len
    g_end = ends + t_idx.astype(np.int64) * tile_len

    # a candidate joins the previous one iff it is its tile's first
    # candidate, the previous candidate sits in the adjacent tile,
    # neither side has a SKIP run at the boundary, and the global gap
    # is within maxGap
    first_in_tile = np.empty(n, bool)
    first_in_tile[0] = True
    first_in_tile[1:] = t_idx[1:] != t_idx[:-1]
    join = np.zeros(n, bool)
    if n > 1:
        prev_t = t_idx[:-1]
        join[1:] = (first_in_tile[1:]
                    & (prev_t == t_idx[1:] - 1)
                    & ~skip_tail[prev_t]
                    & ~skip_head[t_idx[1:]]
                    & (g_start[1:] - g_end[:-1] <= max_gap))
    group = np.cumsum(~join) - 1
    seg = np.flatnonzero(~join)          # first index of each group

    out_start = g_start[seg]
    out_end = g_end[np.append(seg[1:] - 1, n - 1)]
    # float32 AUC: a strict left-fold per group, bit-identical to the
    # sequential loop's `auc = f32(auc + next)` (np.add.reduceat is
    # not — it may reassociate).  One vectorized masked add per chain
    # position: O(longest chain) passes, each across all groups.
    sizes = np.diff(np.append(seg, n))
    out_auc = aucs[seg].astype(np.float32).copy()
    for j in range(1, int(sizes.max())):
        m = sizes > j
        out_auc[m] = (out_auc[m] + aucs[seg[m] + j]) \
            .astype(np.float32)

    # summit: strictly-greater stat wins; equal stat + strictly longer
    # interval wins; otherwise the earlier candidate keeps it.  That
    # is the per-group lexicographic max of (stat, slen) with earliest
    # visit order breaking ties — computed via one ranking sort +
    # segmented min over ranks.
    rank_perm = np.lexsort((np.arange(n), -slen, -sstat))
    rank = np.empty(n, np.int64)
    rank[rank_perm] = np.arange(n)
    win = rank_perm[np.minimum.reduceat(rank, seg)]

    out_pval = spv[win]
    out_qval = sqv[win]
    out_pos = (g_start[win] - out_start) + spos[win]

    keep = (out_auc >= np.float32(min_auc)) \
        & (out_end - out_start >= min_len)
    return [(int(s), int(e), a, p, q, int(x))
            for s, e, a, p, q, x in zip(
                out_start[keep], out_end[keep], out_auc[keep],
                out_pval[keep], out_qval[keep], out_pos[keep])]


def _merge_tile_peaks_loop(result: TileResult, tile_len: int,
                           min_auc: float, min_len: int,
                           max_gap: int):
    """Reference formulation of ``merge_tile_peaks`` (sequential).

    Kept as the oracle for the equivalence property test; the
    vectorized version above must match it tuple-for-tuple.
    """
    assert max_gap < tile_len
    pk = result.peaks
    n_tiles = np.asarray(pk.cand).shape[0]
    cand = np.asarray(pk.cand)
    starts = np.asarray(pk.start)
    ends = np.asarray(pk.end)
    aucs = np.asarray(pk.auc)
    spv = np.asarray(pk.summit_pval)
    sqv = np.asarray(pk.summit_qval)
    spos = np.asarray(pk.summit_pos)
    sstat = np.asarray(pk.summit_stat)
    slen = np.asarray(pk.summit_len)
    skip_head = np.asarray(pk.skip_head)
    skip_tail = np.asarray(pk.skip_tail)

    out = []
    pending = None  # dict of current open peak (global coords)

    def close(p):
        if p is not None and p["auc"] >= np.float32(min_auc) \
                and p["end"] - p["start"] >= min_len:
            out.append((p["start"], p["end"], p["auc"], p["pval"],
                        p["qval"], p["pos"]))

    for t in range(n_tiles):
        idxs = np.flatnonzero(cand[t])
        order = idxs[np.argsort(starts[t, idxs], kind="stable")]
        for j, k in enumerate(order):
            g_start = int(starts[t, k]) + t * tile_len
            g_end = int(ends[t, k]) + t * tile_len
            join = (pending is not None and j == 0
                    and pending["tile"] == t - 1
                    and not pending["skip_tail"]
                    and not bool(skip_head[t])
                    and g_start - pending["end"] <= max_gap)
            if join:
                # merge the boundary candidate into the open peak
                right_pos = int(spos[t, k]) + (g_start
                                               - pending["start"])
                if sstat[t, k] > pending["stat"] or (
                        sstat[t, k] == pending["stat"]
                        and int(slen[t, k]) > pending["slen"]):
                    pending.update(pval=spv[t, k], qval=sqv[t, k],
                                   pos=right_pos, stat=sstat[t, k],
                                   slen=int(slen[t, k]))
                pending["end"] = g_end
                pending["auc"] = np.float32(pending["auc"]
                                            + aucs[t, k])
            else:
                close(pending)
                pending = {"start": g_start, "end": g_end,
                           "auc": np.float32(aucs[t, k]),
                           "pval": spv[t, k], "qval": sqv[t, k],
                           "pos": int(spos[t, k]),
                           "stat": sstat[t, k],
                           "slen": int(slen[t, k])}
            pending["tile"] = t
            pending["skip_tail"] = bool(skip_tail[t])
    close(pending)
    return out


def split_excl_to_tiles(bed, n_tiles: int, tile_len: int) -> np.ndarray:
    """-E pairs (flat [s0, e0, s1, e1, ...]) -> [n_tiles, K, 2]
    tile-local clipped pairs, K a power of two, padded with
    (tile_len, tile_len) rows (the convention _excluded expects).

    Fully vectorized (repeat + one stable sort), same scheme as
    ``split_events_to_tiles``: a pair spanning several tiles is cut at
    every boundary; within a tile, pairs keep input order.  Matters at
    find_ns-scale BED density (a genome-wide N-homopolymer BED can
    hold millions of 1-bp pairs).
    """
    a = np.asarray(bed[0::2], np.int64)
    b = np.asarray(bed[1::2], np.int64)
    keep = (b > a) & (a < n_tiles * tile_len) & (b > 0)
    a, b = a[keep], b[keep]
    if len(a) == 0:
        return np.full((n_tiles, 1, 2), tile_len, np.int32)
    t0 = np.maximum(a, 0) // tile_len
    t1 = np.minimum((b - 1) // tile_len, n_tiles - 1)
    pieces = (t1 - t0 + 1).astype(np.int64)
    off = np.cumsum(pieces) - pieces
    total = int(pieces.sum())
    k_idx = np.arange(total, dtype=np.int64) - np.repeat(off, pieces)
    tile = np.repeat(t0, pieces) + k_idx
    base = tile * tile_len
    lo = np.maximum(np.repeat(a, pieces) - base, 0)
    hi = np.minimum(np.repeat(b, pieces) - base, tile_len)
    order = np.argsort(tile, kind="stable")
    tile_s = tile[order]
    per_tile = np.bincount(tile_s, minlength=n_tiles).astype(np.int64)
    slot = np.arange(total, dtype=np.int64) \
        - np.repeat(np.cumsum(per_tile) - per_tile, per_tile)[:total]
    k = 1
    while k < int(per_tile.max()):
        k <<= 1
    out = np.full((n_tiles, k, 2), tile_len, np.int32)
    out[tile_s, slot, 0] = lo[order]
    out[tile_s, slot, 1] = hi[order]
    return out


def split_events_to_tiles(start: np.ndarray, end: np.ndarray,
                          count: np.ndarray, n_tiles: int,
                          tile_len: int, pad_to: Optional[int] = None,
                          on_overflow: str = "grow"):
    """Host-side: global events -> per-tile padded tile-local arrays.

    A fragment spanning tile boundaries is cut at every boundary into
    per-tile pieces ((s, tile_len) in the first tile, full (0,
    tile_len) covers in any middle tiles, (0, e) in the last), so each
    tile's event list is self-contained and balanced: every add+sub
    row pair is canon-neutral, so the inter-tile class-total carries
    reduce to canonical zero under this convention.  Fully
    vectorized (one repeat + one stable sort); no per-event Python.

    ``pad_to`` sets the minimum per-tile width E (shape stability for
    jit reuse).  If some tile holds more events than ``pad_to``:
    ``on_overflow="grow"`` widens E to fit (single-host default);
    ``"error"`` raises ValueError (multi-host callers, where E must
    agree across processes).  Events are never silently dropped.

    Returns (out_s, out_e, out_c) int32 [n_tiles, E]; padding rows are
    (tile_len, tile_len, 0).
    """
    start = np.asarray(start, np.int64)
    end = np.asarray(end, np.int64)
    count = np.asarray(count, np.int32)
    if len(start) == 0:
        e_max = pad_to or 1
        return (np.full((n_tiles, e_max), tile_len, np.int32),
                np.full((n_tiles, e_max), tile_len, np.int32),
                np.zeros((n_tiles, e_max), np.int32))
    if np.any(start >= end):
        raise ValueError("empty or inverted event (start >= end)")
    ts = start // tile_len
    te = np.minimum((end - 1) // tile_len, n_tiles - 1)  # inclusive
    if np.any(ts >= n_tiles) or np.any(ts < 0):
        raise ValueError("event start outside the tile grid")
    pieces = (te - ts + 1).astype(np.int64)

    # piece k of event i lives in tile ts[i]+k; build the flat piece
    # list with repeat + a concatenated-arange for k
    off = np.cumsum(pieces) - pieces
    total = int(pieces.sum())
    k = np.arange(total, dtype=np.int64) - np.repeat(off, pieces)
    tile = np.repeat(ts, pieces) + k
    base = tile * tile_len
    s_loc = np.maximum(np.repeat(start, pieces) - base, 0)
    e_loc = np.minimum(np.repeat(end, pieces) - base, tile_len)
    c_rep = np.repeat(count, pieces)

    # bucket pieces by tile (stable: preserves input event order)
    order = np.argsort(tile, kind="stable")
    tile_s = tile[order]
    per_tile = np.bincount(tile_s, minlength=n_tiles).astype(np.int64)
    slot = np.arange(total, dtype=np.int64) \
        - np.repeat(np.cumsum(per_tile) - per_tile,
                    per_tile)[: total]
    need = int(per_tile.max()) if total else 1
    e_max = max(pad_to or 1, 1)
    if need > e_max:
        if pad_to is not None and on_overflow == "error":
            raise ValueError(
                f"tile event overflow: a tile holds {need} events "
                f"but pad_to={pad_to} (shape-locked caller)")
        e_max = need
    out_s = np.full((n_tiles, e_max), tile_len, np.int32)
    out_e = np.full((n_tiles, e_max), tile_len, np.int32)
    out_c = np.zeros((n_tiles, e_max), np.int32)
    out_s[tile_s, slot] = s_loc[order]
    out_e[tile_s, slot] = e_loc[order]
    out_c[tile_s, slot] = c_rep[order]
    return out_s, out_e, out_c
