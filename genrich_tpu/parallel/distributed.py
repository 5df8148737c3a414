"""Multi-host initialization and tile-partitioning helpers.

The single-controller program in mesh.py scales to multi-host by
initializing jax.distributed and building the mesh over all global
devices: the tile axis spans hosts, and only the three global
collectives (fragment-length psum, carry all_gather, and the
all_gather of per-shard distinct (p, bp) tables for the exact BH —
see mesh.py) cross between hosts.

The CLI reaches this through ``--engine sharded``: ShardedEngine
calls init_distributed() at startup, which is a no-op without the
JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID env
vars and joins the multi-controller mesh with them (see
tests/test_distributed_2proc.py for the two-process form).

Multi-host hardware is not available in this environment; this module
is exercised only in its single-process form (jax.distributed with
num_processes=1) plus the virtual-device mesh tests.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).

    No-op when unconfigured (single-process run).
    """
    import jax

    coordinator = coordinator or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=int(num_processes
                          or os.environ["JAX_NUM_PROCESSES"]),
        process_id=int(process_id or os.environ["JAX_PROCESS_ID"]))


def local_tile_range(n_tiles: int) -> range:
    """The contiguous block of global tiles this process owns.

    Hosts feed only their own tiles' events to the sharded program
    (jax.make_array_from_process_local_data handles placement).
    """
    import jax

    n_proc = jax.process_count()
    pid = jax.process_index()
    if n_tiles % n_proc:
        raise ValueError(
            f"n_tiles={n_tiles} must be a multiple of the process "
            f"count {n_proc}; pad the tile grid (empty tiles are "
            f"cheap) before sharding")
    per = n_tiles // n_proc
    return range(pid * per, (pid + 1) * per)


def host_local_events(start: np.ndarray, end: np.ndarray,
                      count: np.ndarray, n_tiles: int, tile_len: int,
                      pad_to: int):
    """Split this host's events into its local tile rows.

    Returns [T_local, pad_to] arrays for the tiles in
    ``local_tile_range`` only — the shape
    ``jax.make_array_from_process_local_data`` expects.  ``pad_to`` is
    mandatory (every process must agree on the event width), so
    overflow raises instead of regrowing.
    """
    from .mesh import split_events_to_tiles

    s, e, c = split_events_to_tiles(start, end, count, n_tiles,
                                    tile_len, pad_to,
                                    on_overflow="error")
    r = local_tile_range(n_tiles)
    return s[r.start:r.stop], e[r.start:r.stop], c[r.start:r.stop]


def make_global(mesh, local_rows: np.ndarray, n_tiles: int):
    """This process's tile rows -> a global jax.Array sharded over the
    'tiles' axis (jax.make_array_from_process_local_data)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from .mesh import AXIS

    sh = NamedSharding(mesh, PartitionSpec(AXIS))
    return jax.make_array_from_process_local_data(
        sh, np.ascontiguousarray(local_rows),
        (n_tiles,) + local_rows.shape[1:])


def distributed_analyze(start, end, count, n_tiles: int,
                        tile_len: int, genome_len: int,
                        min_pq: float, min_auc: float,
                        min_len: int = 0, max_gap: int = 100,
                        qval_opt: bool = False, ctrl=None,
                        excl_bed=None, limit=None,
                        pad_to: Optional[int] = None,
                        k_distinct: int = 1 << 13):
    """Full multi-process sharded analysis of one chromosome.

    The multi-controller twin of mesh.sharded_analyze_full: every
    process calls this with the same parameters; device arrays are
    built with make_array_from_process_local_data so each process
    feeds only its local tiles (host_local_events), collectives span
    the global mesh, and the outputs that reach the host (fragment
    scalars, the distinct (p, bp) tables, the per-tile peak arrays)
    ride replicated specs so every process computes the identical
    final peak list.

    Returns (peaks, lam, factor) where peaks is the merged
    [(start, end, auc, summit_pval, summit_qval, summit_pos)] list.
    """
    import jax
    import jax.numpy as jnp

    from ..ops.pipeline_jax import TileResult
    from .mesh import (ShardedKernels, exact_q_table, make_mesh,
                       merge_tile_peaks, split_events_to_tiles,
                       split_excl_to_tiles)

    mesh = make_mesh()
    kern = ShardedKernels(mesh, tile_len, k_distinct)

    if ctrl is None:
        ctrl = (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.int32))
    if pad_to is None:
        # width must be agreed across processes: derive it from the
        # full (replicated) event lists
        w = 1
        for (s_, e_, c_) in ((start, end, count), ctrl):
            rows = split_events_to_tiles(s_, e_, c_, n_tiles,
                                         tile_len)[0]
            while w < rows.shape[1]:
                w <<= 1
        pad_to = w

    r = local_tile_range(n_tiles)
    es, ee, ec = host_local_events(start, end, count, n_tiles,
                                   tile_len, pad_to)
    cs, ce, cc = host_local_events(ctrl[0], ctrl[1], ctrl[2],
                                   n_tiles, tile_len, pad_to)
    excl = split_excl_to_tiles(excl_bed or [], n_tiles, tile_len)
    if limit is None:
        limit = np.full(n_tiles, tile_len, np.int32)
    args = [make_global(mesh, x, n_tiles) for x in
            (es, ee, ec, cs, ce, cc, excl[r.start:r.stop],
             np.asarray(limit, np.int32)[r.start:r.stop])]

    (starts, ends, ev, cr, excluded, live, frag_all,
     cfrag_all) = kern.cov(*args)
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
    res = kern.peaks(qval_opt, min_len, max_gap, replicated=True)(
        starts, ends, pval, live, jnp.asarray(tab_p),
        jnp.asarray(tab_q), jnp.float32(min_pq),
        jnp.float32(min_auc))
    peaks = merge_tile_peaks(TileResult(res, None, None), tile_len,
                             min_auc, min_len, max_gap)
    return peaks, float(lam), float(factor)
