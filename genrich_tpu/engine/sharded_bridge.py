"""Multi-device sharded engine for the CLI (--engine sharded).

Same duck-typed interface as :class:`engine.jax_bridge.JaxEngine`, but
every numeric stage runs as a ``shard_map`` over a 1-D tile mesh of
all available devices: each chromosome is cut into D tiles (D = mesh
size, tile length a power of two), events are routed to tiles by the
vectorized host splitter, and the device steps (ShardedKernels in
parallel/mesh.py) exchange only scalars and the distinct (p, bp)
tables between shards.  Peaks straddling tile boundaries merge on the
host (merge_tile_peaks).

Reference semantics per stage (float32, same tolerances as
--engine jax; see PARITY.md):
  coverage/pileup   savePileupExpt/Ctrl   Genrich.c:2052-2295
  p-values          savePval/calcPval     Genrich.c:1628-1794
  Fisher            combinePval           Genrich.c:612-667
  q-values          computeQval           Genrich.c:146-401 (exact
                    distinct-value BH, host float32 sweep)
  peak calling      callPeaks             Genrich.c:977-1069

On one device this degenerates gracefully (D tiles on one card); on
several cards of one host the tile axis spans them, and XLA carries
the collectives over NCCL.  Tests exercise it on a virtual 8-device
CPU mesh (tests/test_engine_jax_cli.py, ENGINES includes "sharded").
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.cfloat import SKIP
from ..utils.xla_cache import enable_compile_cache
from .host_fallback import INT32_MAX, HostChromMixin
from .perf import PerfMixin
from .pileup import Pileup

F32 = np.float32
PEAK_CAP = 4096            # per-tile candidate rows (call_peaks k)


def _pow2(n: int, lo: int = 1) -> int:
    size = lo
    while size < n:
        size <<= 1
    return size


class ShardedEngine(PerfMixin, HostChromMixin):
    """Per-run sharded device context (lazy jax import)."""

    def __init__(self, n_devices: Optional[int] = None,
                 min_tile_len: int = 1 << 16):
        enable_compile_cache()
        from ..parallel.distributed import init_distributed
        init_distributed()   # no-op unless JAX_COORDINATOR_ADDRESS set
        import jax
        from ..parallel import mesh as pmesh

        self.jax = jax
        self.pmesh = pmesh
        self.mesh = pmesh.make_mesh(n_devices)
        self.devices = list(self.mesh.devices.flat)
        self.D = len(self.devices)
        self.min_tile_len = min_tile_len
        self._kernels: Dict[int, "pmesh.ShardedKernels"] = {}
        # padded empty event triples keyed by (n_tiles, w, tile_len):
        # no-ctrl analyses otherwise upload constant padding per
        # chromosome per run (serve mode reuses across analyses)
        self._empty_cache: Dict[tuple, tuple] = {}
        self._chrom: Dict[int, dict] = {}
        self._reps: List[Dict[int, tuple]] = []
        self._qtable = None
        self._qtable_host = (np.zeros(0, F32), np.zeros(0, F32))
        import jax.numpy as jnp
        self.jnp = jnp               # PerfMixin helpers
        self.begin_run()

        from functools import partial

        @partial(jax.jit, static_argnames=("size",))
        def _expand_flat16(fs, fl, fc, off, tile_len, size):
            # flat tile-major events + [T+1] offsets -> [T, size]
            # padded triple; rows beyond a tile's count become
            # (tile_len, tile_len, 0) padding on device
            idx = off[:-1, None] + jnp.arange(size, dtype=jnp.int32)
            valid = idx < off[1:, None]
            idxc = jnp.minimum(idx, fs.shape[0] - 1)
            s = jnp.where(valid, fs[idxc], tile_len)
            e = jnp.where(valid, s + fl[idxc].astype(jnp.int32),
                          tile_len)
            c = jnp.where(valid, fc[idxc], 0).astype(jnp.uint8)
            return s, e, c

        @partial(jax.jit, static_argnames=("size",))
        def _expand_flat32(fs, fe, fc, off, tile_len, size):
            idx = off[:-1, None] + jnp.arange(size, dtype=jnp.int32)
            valid = idx < off[1:, None]
            idxc = jnp.minimum(idx, fs.shape[0] - 1)
            s = jnp.where(valid, fs[idxc], tile_len)
            e = jnp.where(valid, fe[idxc], tile_len)
            c = jnp.where(valid, fc[idxc], 0).astype(jnp.uint8)
            return s, e, c

        self._expand_flat16 = _expand_flat16
        self._expand_flat32 = _expand_flat32

    # --- grid construction ----------------------------------------------

    MAX_TILE_LEN = 1 << 28   # cap: keeps positions well inside int32
                             # and bounds per-tile sort size; a chrom
                             # larger than D*cap gets several tiles
                             # per device (the kernels vmap over the
                             # local tile axis)

    def prepare(self, max_events: int, max_excl_pairs: int,
                min_pq: float, min_auc: float, min_len: int,
                max_gap: int, use_q: bool,
                max_chrom_len: int = 0) -> None:
        """Fix ONE global (tile_len, n_tiles) grid for the run.

        Without this, every chromosome length yields its own
        [n_tiles, E] program shapes — a dozen compiled executables,
        each compiled once per process.  Padding every chromosome to
        the largest one's grid (trailing tiles get limit 0) trades a
        few percent of tile compute for a single shape set per stage.
        """
        # runs once per analysis: re-derives the grid and event-width
        # floor from THIS run's maxima, so a serve process fed
        # heterogeneous inputs never inherits a stale (too small or
        # over-padded) shape policy.  Compiled kernels (self._kernels,
        # keyed by tile_len) and the empty-upload cache persist.
        if not max_chrom_len:
            self._fixed_grid = None
            self._e_floor = 1
            return
        tl = _pow2(-(-max_chrom_len // self.D), lo=self.min_tile_len)
        tl = min(tl, self.MAX_TILE_LEN)
        t = -(-max_chrom_len // tl)
        t = -(-t // self.D) * self.D
        self._fixed_grid = (tl, t)
        # event-width floor: the mean per-tile count; the first
        # chromosome's actual split raises the monotone floor to the
        # real (cluster-skewed) width, and later chromosomes reuse
        # that shape.  Over-padding here costs real upload bytes on
        # the device link, so keep the floor tight.
        self._e_floor = _pow2(max(1, max_events // max(t, 1)))

    def _grid(self, chrom_len: int) -> Tuple[int, int, np.ndarray]:
        """(tile_len, n_tiles, per-tile limits) for a chromosome:
        power-of-two tile length, tile count a multiple of the mesh
        size D (bounded set of jit shapes); uses the global fixed
        grid from prepare() when one is set and large enough."""
        fixed = getattr(self, "_fixed_grid", None)
        if fixed is not None and fixed[0] * fixed[1] >= chrom_len:
            tl, t = fixed
        else:
            tl = _pow2(-(-chrom_len // self.D), lo=self.min_tile_len)
            tl = min(tl, self.MAX_TILE_LEN)
            t = -(-chrom_len // tl)
            t = -(-t // self.D) * self.D
        limit = np.clip(chrom_len - np.arange(t) * tl, 0, tl)
        return tl, t, limit.astype(np.int32)

    def _kern(self, tile_len: int):
        k = self._kernels.get(tile_len)
        if k is None:
            k = self.pmesh.ShardedKernels(self.mesh, tile_len)
            self._kernels[tile_len] = k
        return k

    def _split(self, ev, tile_len: int, n_tiles: int):
        """Events -> [n_tiles, E] tile-local arrays (natural width)."""
        if ev is None or len(ev[0]) == 0:
            e = np.full((n_tiles, 1), tile_len, np.int32)
            return e, e.copy(), np.zeros((n_tiles, 1), np.int32)
        return self.pmesh.split_events_to_tiles(
            ev[0], ev[1], ev[2], n_tiles, tile_len)

    def _stage_events(self, s, e, c, w: int, tile_len: int):
        """Upload one [T, *] event triple FLAT, expand to [T, w].

        The padded [T, E] layout wastes the wire on tile skew: with
        clustered (ATAC-like) events every tile ships the densest
        tile's width.  Instead the link carries exactly the real
        events, tile-major — starts int32 + lengths uint16 (when
        they fit; int32 ends otherwise) + counts uint8 — plus a
        [T+1] int32 offset vector; the device expand gathers each
        tile's slice into the compiled [T, w] shape and materializes
        the padding rows in HBM.  The flat length is rounded up to a
        power-of-two granule (monotone per engine) so jit shapes
        stay bounded across chromosomes and analyses.
        """
        import jax.numpy as jnp
        n_tiles, wn = s.shape
        real = s != tile_len          # padding rows are (tl, tl, 0)
        per_tile = real.sum(axis=1).astype(np.int64)
        off = np.zeros(n_tiles + 1, np.int32)
        off[1:] = np.cumsum(per_tile).astype(np.int32)
        fs = s[real].astype(np.int32)
        fe = e[real].astype(np.int64)
        fc = c[real].astype(np.uint8)
        n = len(fs)
        # 1/8-octave size buckets: at most 8 compiled expand shapes
        # per power of two, padding waste <= 12.5% — a monotone pow2
        # floor here measured 44 MB on the 2M-pair bench workload
        # (every chromosome padded to the largest's power of two)
        # where the real events are ~31 MB
        base = _pow2(max(n, 1), lo=1 << 13)
        granule = base >> 3
        cap = -(-max(n, 1) // granule) * granule
        pad = cap - n
        fs = np.pad(fs, (0, pad), constant_values=tile_len)
        fc = np.pad(fc, (0, pad))
        lens = fe - s[real]
        if n == 0 or (int(lens.max(initial=0)) < (1 << 16)
                      and int(lens.min(initial=0)) >= 0):
            fl = np.pad(lens.astype(np.uint16), (0, pad))
            return self._call(
                self._expand_flat16, self._put(fs), self._put(fl),
                self._put(fc), self._put(off), jnp.int32(tile_len),
                size=w)
        fe32 = np.pad(fe.astype(np.int32), (0, pad),
                      constant_values=tile_len)
        return self._call(
            self._expand_flat32, self._put(fs), self._put(fe32),
            self._put(fc), self._put(off), jnp.int32(tile_len),
            size=w)

    def _split_excl(self, bed: List[int], tile_len: int,
                    n_tiles: int) -> np.ndarray:
        """-E pairs -> [n_tiles, K, 2] tile-local clipped pairs."""
        return self.pmesh.split_excl_to_tiles(bed, n_tiles, tile_len)

    # --- stage 1: coverage (resident) ------------------------------------

    def coverage_chrom(self, cidx: int, expt_ev, ctrl_ev,
                       bed: List[int], chrom_len: int
                       ) -> Tuple[float, float]:
        if chrom_len > INT32_MAX:
            # device coordinates are int32: exact-engine host fallback
            return self.host_coverage_chrom(cidx, expt_ev, ctrl_ev,
                                            bed, chrom_len)
        import jax.numpy as jnp
        tile_len, n_tiles, limit = self._grid(chrom_len)
        kern = self._kern(tile_len)
        es, ee, ec = self._split(expt_ev, tile_len, n_tiles)
        cs, ce, cc = self._split(ctrl_ev, tile_len, n_tiles)
        # one sort width for expt+ctrl; monotone floor keeps later
        # chromosomes on the same compiled shapes within an analysis
        w = _pow2(max(es.shape[1], cs.shape[1]),
                  lo=getattr(self, "_e_floor", 1))
        self._e_floor = w
        excl = self._split_excl(bed, tile_len, n_tiles)
        if ctrl_ev is None or len(ctrl_ev[0]) == 0:
            key = (n_tiles, w, tile_len)
            cached = self._empty_cache.get(key)
            if cached is None:
                # stage the all-padding triple through the flat
                # expand kernel: the wire carries a minimum-granule
                # flat array + offsets instead of a full [n_tiles, w]
                # constant (was the bulk of the sharded engine's
                # upload tax on no-ctrl runs)
                cached = self._stage_events(
                    np.full((n_tiles, 0), tile_len, np.int64),
                    np.full((n_tiles, 0), tile_len, np.int64),
                    np.zeros((n_tiles, 0), np.int64), w, tile_len)
                self._empty_cache[key] = cached
            cs_d, ce_d, cc_d = cached
        else:
            cs_d, ce_d, cc_d = self._stage_events(cs, ce, cc, w,
                                                  tile_len)
        es_d, ee_d, ec_d = self._stage_events(es, ee, ec, w, tile_len)
        out = self._call(kern.cov, es_d, ee_d, ec_d, cs_d, ce_d,
                         cc_d, self._put(excl), self._put(limit))
        (starts, ends, ev, cr, excluded, live, frag_all,
         cfrag_all) = out
        self._chrom[cidx] = {
            "starts": starts, "ends": ends, "ev": ev, "cr": cr,
            "excluded": excluded, "live": live, "len": chrom_len,
            "tile_len": tile_len, "limit": limit,
        }
        return frag_all, cfrag_all

    def coverage_finish(self, handles) -> Tuple[float, float]:
        """Resolve queued coverage handles (one blocking gather).

        Per-chromosome reduction and accumulation order match the
        previous synchronous loop exactly (numpy float64 sum of the
        per-tile sums, then Python float adds in submission order).
        """
        import time as _time
        t0 = _time.perf_counter()
        vals = self.jax.device_get(list(handles))
        self.perf["fetch_n"] += 1
        self.perf["fetch_s"] += _time.perf_counter() - t0
        frag = 0.0
        cfrag = 0.0
        for fe, fc in vals:
            frag += float(np.asarray(fe, np.float64).sum())
            cfrag += float(np.asarray(fc, np.float64).sum())
        return frag, cfrag

    # --- stage 2: p-values (resident) -------------------------------------

    def stats_all(self, lam: float, factor: float) -> None:
        import jax.numpy as jnp
        self._lam = F32(lam)
        self._factor = F32(factor)
        for st in self._chrom.values():
            if st.get("host"):
                continue
            kern = self._kern(st["tile_len"])
            st["pv"] = self._call(kern.stats, st["ev"], st["cr"],
                                  st["excluded"], jnp.float32(lam),
                                  jnp.float32(factor))
        self.host_stats(lam, factor)

    # --- multi-replicate: archive + sharded Fisher ------------------------

    def archive_replicate(self) -> None:
        """Per-tile p-value RLE compaction; coverage arrays released."""
        import jax.numpy as jnp
        rep: Dict[int, tuple] = {}
        for cidx, st in self._chrom.items():
            if st.get("host"):
                rep[cidx] = self.host_archive(st)
                continue
            kern = self._kern(st["tile_len"])
            e_b, pv_b, b = kern.rle_pv(
                st["starts"], st["ends"], st["pv"], st["live"],
                jnp.asarray(st["limit"]))
            rep[cidx] = (e_b, pv_b, st["len"], st["tile_len"],
                         st["limit"])
        self._reps.append(rep)
        self._chrom.clear()

    def finalize_fisher(self) -> None:
        """combinePval across replicates, per tile on the mesh."""
        chroms = sorted({c for rep in self._reps for c in rep})
        for cidx in chroms:
            present = [rep[cidx] for rep in self._reps if cidx in rep]
            if any(self.host_is_archived(r) for r in present):
                self.host_fisher(cidx, present)
                continue
            r = len(present)
            kern = self._kern(present[0][3])
            fn = kern.fisher(r)
            args = tuple(p[0] for p in present) \
                + tuple(p[1] for p in present)
            starts, ends, comb, live = fn(*args)
            self._chrom[cidx] = {
                "starts": starts, "ends": ends, "pv": comb,
                "live": live, "len": present[0][2],
                "tile_len": present[0][3], "limit": present[0][4],
            }
        self._reps.clear()

    # --- host-RLE paths (-f/-k logs, host Fisher, -X, fallbacks) ----------

    def pval_pileup(self, cidx: int) -> Pileup:
        import jax.numpy as jnp
        st = self._chrom[cidx]
        if st.get("host"):
            return self.host_pval_pileup(st)
        kern = self._kern(st["tile_len"])
        e_b, pv_b, b = kern.rle_pv(st["starts"], st["ends"], st["pv"],
                                   st["live"],
                                   jnp.asarray(st["limit"]))
        ends, (pv,) = self._stitch(e_b, (pv_b,), b, st)
        if len(ends) == 0:
            return Pileup(np.array([st["len"]], np.int64),
                          np.zeros(1, F32))
        return Pileup(ends, pv)

    def pvalue_pileups(self, cidx: int
                       ) -> Tuple[Pileup, Pileup, Pileup]:
        import jax.numpy as jnp
        st = self._chrom[cidx]
        if st.get("host"):
            return self.host_pvalue_pileups(st)
        kern = self._kern(st["tile_len"])
        e_b, pv_b, ev_b, cv_b, b = kern.rle(
            st["starts"], st["ends"], st["pv"], st["ev"], st["cr"],
            st["excluded"], st["live"], jnp.float32(self._lam),
            jnp.float32(self._factor))
        ends, (pv, ev, cv) = self._stitch(e_b, (pv_b, ev_b, cv_b), b,
                                          st)
        if len(ends) == 0:
            chrom_len = st["len"]
            pu = Pileup(np.array([chrom_len], np.int64),
                        np.zeros(1, F32))
            return (Pileup(pu.end, np.zeros(1, F32)),
                    Pileup(pu.end, np.full(1, F32(self._lam))), pu)
        return Pileup(ends, ev), Pileup(ends, cv), Pileup(ends, pv)

    def _stitch(self, e_b, vals, b, st):
        """Per-tile RLE arrays -> one chromosome RLE (host).

        Offsets tile-local ends to chromosome coordinates and merges
        the artificial run break at each tile boundary when the
        run-defining p-value is equal on both sides (keeping the later
        run's companion values, i.e. the run's final boundary row).
        """
        tile_len = st["tile_len"]
        fetched = self._fetch_many((b, e_b) + tuple(vals))
        b_np, e_np = fetched[0], fetched[1]
        v_np = list(fetched[2:])
        ends_parts, val_parts = [], [[] for _ in v_np]
        for t in range(e_np.shape[0]):
            n = int(b_np[t])
            if n == 0:
                continue
            ends_parts.append(e_np[t, :n].astype(np.int64)
                              + t * tile_len)
            for j, v in enumerate(v_np):
                val_parts[j].append(v[t, :n])
        if not ends_parts:
            return np.zeros(0, np.int64), tuple(
                np.zeros(0, F32) for _ in v_np)
        ends = np.concatenate(ends_parts)
        vs = [np.concatenate(p) for p in val_parts]
        # merge runs across tile boundaries: drop row i when the next
        # row has the same p-value (vs[0] is the run key)
        same = np.concatenate([vs[0][1:] == vs[0][:-1],
                               np.zeros(1, bool)])
        boundary = (ends % tile_len) == 0
        drop = same & boundary & (ends < st["len"])
        keep = ~drop
        return ends[keep], tuple(v[keep] for v in vs)

    # --- stage 3: q-values -------------------------------------------------

    def qvalue_table(self, genome_len: int) -> bool:
        """Exact genome-wide BH from sharded distinct (p, bp) tables."""
        from . import qvalue
        import jax.numpy as jnp
        ps, ws = [], []
        # submit every chromosome's distinct program before resolving
        # any (fetches then overlap the remaining dispatches); a
        # too-small k re-dispatches just that chromosome — loud,
        # never silent truncation
        pend = []
        for st in self._chrom.values():
            if st.get("host"):
                hp, hw = self.host_distinct(st)
                if len(hp):
                    ps.append(np.asarray(hp, F32))
                    ws.append(np.asarray(hw, np.uint64))
                continue
            kern = self._kern(st["tile_len"])
            pend.append((st, kern, self._call(
                kern.distinct, st["starts"], st["ends"], st["pv"],
                st["live"])))
        # resolve all chromosomes' counts in ONE pull, re-dispatch
        # any whose distinct table overflowed k, then pull every
        # (pv, w) table in a second single round trip — per-chrom
        # pulls were ~6 of the sharded engine's 13 warm fetches
        d_nps = []
        while pend:
            d_nps = [d.reshape(-1) for d in self._fetch_many(
                [out[2] for _, _, out in pend])]
            redo = [i for i, ((st, kern, _), d_np)
                    in enumerate(zip(pend, d_nps))
                    if not (d_np <= kern.k).all()]
            if not redo:
                break
            for i in redo:
                st, kern, _ = pend[i]
                kern = self.pmesh.ShardedKernels(
                    self.mesh, st["tile_len"],
                    k_distinct=_pow2(int(d_nps[i].max())))
                self._kernels[st["tile_len"]] = kern
                pend[i] = (st, kern, self._call(
                    kern.distinct, st["starts"], st["ends"],
                    st["pv"], st["live"]))
        if pend:
            flat = self._fetch_many(
                [x for _, _, (pv_all, w_all, _) in pend
                 for x in (pv_all, w_all)])
            for j, ((st, kern, _), d_np) in enumerate(
                    zip(pend, d_nps)):
                pv_g, w_g = flat[2 * j], flat[2 * j + 1]
                for i, d in enumerate(d_np):
                    d = int(d)
                    if d:
                        ps.append(pv_g[i * kern.k:i * kern.k + d])
                        ws.append(w_g[i * kern.k:i * kern.k + d]
                                  .astype(np.uint64))
        if not ps:
            self._qtable = (jnp.zeros(1, jnp.float32),
                            jnp.zeros(1, jnp.float32))
            self._qtable_host = (np.zeros(0, F32), np.zeros(0, F32))
            return False
        uv, qv, tab_p, tab_q, _, all_one = \
            qvalue.merge_distinct_tables(ps, ws, genome_len,
                                         lo=1 << 8)
        self._qtable = (jnp.asarray(tab_p), jnp.asarray(tab_q))
        self._qtable_host = (uv, qv)
        return all_one

    # --- stage 4: peaks ------------------------------------------------------

    def peaks_submit(self, cidx: int, min_pq: float, min_auc: float,
                     min_len: int, max_gap: int, use_q: bool):
        """Dispatch sharded peak calling (no blocking); None for a
        host-fallback chromosome or a gap the boundary merge cannot
        honor (caller falls back to the host peak caller)."""
        import jax.numpy as jnp
        st = self._chrom[cidx]
        if st.get("host"):
            return None    # pipeline falls back to the host caller
        kern = self._kern(st["tile_len"])
        if max_gap >= st["tile_len"]:
            return None    # boundary merge assumes gap < tile
        if use_q:
            tab_p, tab_q = self._qtable
        else:
            tab_p = tab_q = jnp.zeros(1, jnp.float32)
        res = self._call(
            kern.peaks(use_q, min_len, max_gap), st["starts"],
            st["ends"], st["pv"], st["live"], tab_p, tab_q,
            jnp.float32(min_pq), jnp.float32(min_auc))
        cap = min(PEAK_CAP, st["starts"].shape[1])
        return (res, st, cap, min_auc, min_len, max_gap)

    def peaks_fetch(self, handle):
        """Resolve a ``peaks_submit`` handle: cap check + host
        boundary merge.  Returns peak arrays or None when a tile
        exceeded the candidate cap."""
        import time as _time
        from ..ops.pipeline_jax import TileResult
        res, st, cap, min_auc, min_len, max_gap = handle
        # one device_get for the whole TilePeaks pytree: the merge
        # reads most fields, and per-field np.asarray pulls would each
        # pay a link round trip
        t0 = _time.perf_counter()
        res = self.jax.device_get(res)
        self.perf["fetch_n"] += 1
        self.perf["fetch_s"] += _time.perf_counter() - t0
        if int(res.n_peaks.max()) > cap:
            return None
        merged = self.pmesh.merge_tile_peaks(
            TileResult(res, None, None), st["tile_len"], min_auc,
            min_len, max_gap)
        if not merged:
            z64 = np.zeros(0, np.int64)
            zf = np.zeros(0, F32)
            return (z64, z64, zf, zf, zf, z64)
        starts = np.array([m[0] for m in merged], np.int64)
        ends = np.array([m[1] for m in merged], np.int64)
        aucs = np.array([m[2] for m in merged], F32)
        spv = np.array([m[3] for m in merged], F32)
        sqv = np.array([m[4] for m in merged], F32)
        spos = np.array([m[5] for m in merged], np.int64)
        return starts, ends, aucs, spv, sqv, spos

    def peaks_chrom(self, cidx: int, min_pq: float, min_auc: float,
                    min_len: int, max_gap: int, use_q: bool):
        """Blocking submit+fetch (single-chromosome convenience)."""
        h = self.peaks_submit(cidx, min_pq, min_auc, min_len,
                              max_gap, use_q)
        return None if h is None else self.peaks_fetch(h)

    def release(self) -> None:
        self._chrom.clear()
        self._reps.clear()
        self._qtable = None
