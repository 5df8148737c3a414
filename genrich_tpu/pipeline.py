"""Main analysis pipeline: the runProgram equivalent (Genrich.c:5386-5695).

Replicate loop: parse expt/ctrl SAM/BAM -> fragment events -> pileups ->
per-replicate p-values; then findPeaks (combine across replicates,
q-values, peak calling / logging).  All numeric stages run through
:mod:`genrich_tpu.engine` (vectorized with C-exact semantics).
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np

from .engine import chisq, peaks as peaks_mod, pvalue, qvalue
from .engine.pileup import (Pileup, calc_factor, calc_lambda,
                            const_pileup, ctrl_frag_terms, ctrl_pileup,
                            expt_pileup, lambda_pileup)
from .errors import ERREXPT, ERRGEN, ERRISSUE, fatal, warn
from .ingest.bam import read_bam
from .ingest.chroms import ChromRegistry
from .ingest.counters import FileCounters
from .ingest.dedup import DedupState, find_dups
from .ingest.intervals import EventSink, IntervalWriter, UnpairBuffer
from .ingest.sam import read_sam
from .io import files
from .io.bed import load_bed
from .output import writers
from .params import MAX_ALNS, Params
from .utils.cfloat import SKIP, fmt_f, fmt_prec

F32 = np.float32


_PROFILE = os.environ.get("GENRICH_TPU_PROFILE", "") not in ("", "0")


@contextmanager
def stage(name: str, perf: Optional[dict] = None,
          key: Optional[str] = None):
    """Per-stage wall timer; the reference has no profiling at all
    (SURVEY.md §5) — this is an extension.  GENRICH_TPU_PROFILE=1
    prints to stderr; a ``perf`` dict (serve mode) accumulates the
    wall seconds under ``key`` for the bench decomposition."""
    if not _PROFILE and perf is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if _PROFILE:
            sys.stderr.write(f"[profile] {name}: {dt:.3f}s\n")
        if perf is not None and key:
            perf[key] = perf.get(key, 0.0) + dt


def _i64(x: int) -> int:
    """Render a uint64 through C's %ld (reinterpret as int64)."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >= (1 << 63) else x


def _is_bam(filename: str) -> bool:
    """Detect BAM (gzip magic + 'BAM\\1') for the -v counter label."""
    try:
        import gzip
        with open(filename, "rb") as f:
            if f.read(2) != b"\x1f\x8b":
                return False
        with gzip.open(filename, "rb") as g:
            return g.read(4) == b"BAM\x01"
    except OSError:
        return False


def _split_files(s: Optional[str]) -> List[str]:
    """strtok with COM=", " (Genrich.h:24): split on comma/space."""
    if s is None:
        return []
    return [f for f in s.replace(",", " ").split() if f]


def _chrom_events(sink: EventSink, chrom_index: int):
    buf = sink.by_chrom.get(chrom_index)
    if buf is None:
        return None
    return (np.asarray(buf[0], np.int64), np.asarray(buf[1], np.int64),
            np.asarray(buf[2], np.int64))


def _par_map(fn, items):
    """Map fn over per-chromosome work items, in parallel when it can
    help.  Results come back in input order, so every downstream
    reduction (exact float64 fragment sums, BH tables, log writers)
    sees exactly the sequential order — numpy's big-array ufuncs and
    the ctypes breakpoint kernel release the GIL, so chromosomes
    genuinely overlap.  The reference is single-threaded
    (Genrich.c:5386-5695 runs its chromosome loops serially)."""
    import os as _os
    # cores-1 workers: on a 2-core box 2-thread numerics measured a
    # WASH at <=100M records and a 27 s LOSS at 146M (glibc main-
    # arena contention on GB-scale temporaries once the heap starts
    # growing under the lock), so the serial path is the 2-core
    # default; GENRICH_NUMERIC_THREADS overrides in either direction
    n = min(len(items), max(1, (_os.cpu_count() or 2) - 1), 4)
    env = _os.environ.get("GENRICH_NUMERIC_THREADS", "")
    if env:
        n = min(len(items), max(1, int(env)))
    if n <= 1 or len(items) <= 1:
        return [fn(it) for it in items]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=n) as ex:
        return list(ex.map(fn, items))


def _append_text(path: Optional[str], gz: bool, text: str) -> None:
    """Append a header line to a log written incrementally (native
    mode appends from C++; gzip outputs become multi-member)."""
    if not path:
        return
    import gzip as _gzip
    real = files.resolve_out_path(path, gz)
    if gz:
        with _gzip.open(real, "at") as f:
            f.write(text)
    else:
        with open(real, "a") as f:
            f.write(text)


def _sync_registry(nat, registry: ChromRegistry) -> None:
    """Mirror the native chrom registry into the Python one."""
    for (name, length, skip, save, bed) in nat.chroms():
        c = registry.by_name.get(name)
        if c is None:
            from .ingest.chroms import Chrom
            c = Chrom(name, length, skip, save, bed,
                      len(registry.chroms))
            registry.chroms.append(c)
            registry.by_name[name] = c
        else:
            c.save = save
            c.skip = skip
            c.bed = bed


def _parse_file_native(nat, filename: str, registry: ChromRegistry,
                       p: Params, sink: EventSink, ctrl: bool,
                       sample: int) -> FileCounters:
    """Parse one file through the C++ ingest library."""
    bed_path = files.resolve_out_path(p.bed_file, p.gz_out) \
        if p.bed_file else None
    dups_path = files.resolve_out_path(p.dups_file, p.gz_out) \
        if p.dups_opt and p.dups_file else None
    nat.parse(filename, ctrl, sample, bed_path, dups_path, p.gz_out)
    _sync_registry(nat, registry)
    counters = FileCounters(**nat.counters())
    for c in registry:
        ev = nat.events(c.index)
        if ev is not None:
            sink.by_chrom[c.index] = [ev[0], ev[1], ev[2]]
    return counters


def _parse_file(filename: str, registry: ChromRegistry, p: Params,
                sink: EventSink, bed_stream, dups_stream, ctrl: bool,
                sample: int):
    """Open and parse one SAM/BAM input; returns (counters, writer, bam)."""
    stream, gz = files.open_read(filename)
    bam = gz and files.check_bam(stream)
    counters = FileCounters()
    writer = IntervalWriter(sink, bed_stream, ctrl=ctrl, sample=sample,
                            verbose=p.verbose)
    unpair = UnpairBuffer() if p.avg_ext_opt else None
    dedup = DedupState() if p.dups_opt else None
    if bam:
        counters.count = read_bam(stream, registry, counters, writer,
                                  (unpair, dedup), p, ctrl)
    else:
        counters.count = read_sam(stream, registry, counters, writer,
                                  (unpair, dedup), p, ctrl)
    stream.close()

    if p.dups_opt:
        find_dups(dedup, counters, writer, p.single_opt, p.extend_opt,
                  p.extend, p.avg_ext_opt, p.as_diff, p.atac_opt,
                  p.atac_len5, p.atac_len3, p.atac_adj,
                  dups_stream, p.verbose)
    elif p.avg_ext_opt:
        unpair.process(writer, counters.total_len, counters.paired_pr,
                       p.verbose)
    return counters, writer, bam


def _compute_genome_len(registry: ChromRegistry, use_chrom) -> int:
    """Genome length over selected chroms minus -E regions."""
    total = 0
    for c in registry:
        if use_chrom(c):
            total += c.length
            for j in range(0, len(c.bed), 2):
                total -= c.bed[j + 1] - c.bed[j]
    return total


def _save_pileup_expt(registry: ChromRegistry, sink: EventSink
                      ) -> tuple:
    """savePileupExpt over all chroms; returns (pileups, fragLen)."""
    out: Dict[int, Pileup] = {}
    all_terms = []
    work = []
    for c in registry:
        if c.skip or not c.save:
            continue
        ev = _chrom_events(sink, c.index)
        if ev is None:
            out[c.index] = const_pileup(c.length, F32(0.0))
            continue
        work.append((c, ev))
    for (c, _), (pu, terms) in zip(work, _par_map(
            lambda w: expt_pileup(w[1][0], w[1][1], w[1][2],
                                  w[0].length, w[0].bed), work)):
        out[c.index] = pu
        all_terms.append(terms)
    from .engine.pileup import exact_sum_f64
    frag_len = exact_sum_f64(
        np.concatenate(all_terms) if all_terms
        else np.zeros(0, F32))
    if frag_len == 0.0:
        raise fatal("", ERREXPT)
    return out, frag_len


def _save_pileup_ctrl(registry: ChromRegistry, sink: EventSink,
                      frag_len: float, genome_len: int,
                      verbose: bool) -> Dict[int, Pileup]:
    """savePileupCtrl (Genrich.c:2052-2161)."""
    lam = _calc_lambda(registry, frag_len, genome_len)
    if verbose:
        warn(f"  Background pileup value: {fmt_f(lam)}\n")
    work = []
    for c in registry:
        if c.skip or not c.save:
            continue
        ev = _chrom_events(sink, c.index)
        if ev is None:
            continue
        work.append((c, ev))
    ctrl_terms = _par_map(
        lambda w: ctrl_frag_terms(w[1][0], w[1][1], w[1][2],
                                  w[0].length, w[0].bed), work)
    from .engine.pileup import exact_sum_f64
    ctrl_frag = exact_sum_f64(
        np.concatenate(ctrl_terms) if ctrl_terms
        else np.zeros(0, F32))
    factor = calc_factor(frag_len, ctrl_frag)
    if verbose:
        warn(f"  Scaling factor for control pileup: {fmt_f(factor)}\n")
        if factor > F32(5.0):
            warn("  ** Warning! Large scaling may mask true signal **\n")
    out: Dict[int, Pileup] = {}
    work2 = []
    for c in registry:
        if c.skip or not c.save:
            continue
        ev = _chrom_events(sink, c.index)
        if ev is None:
            out[c.index] = lambda_pileup(c.length, c.bed, lam)
        else:
            work2.append((c, ev))
    for (c, _), pu in zip(work2, _par_map(
            lambda w: ctrl_pileup(w[1][0], w[1][1], w[1][2],
                                  w[0].length, w[0].bed, factor,
                                  lam), work2)):
        out[c.index] = pu
    return out


def _calc_lambda(registry: ChromRegistry, frag_len: float,
                 genome_len: int) -> np.float32:
    if not genome_len:
        genome_len = _compute_genome_len(
            registry, lambda c: not c.skip and c.save)
        if not genome_len:
            raise fatal("", ERRGEN)
    return calc_lambda(frag_len, genome_len)


def _save_pileup_noctrl(registry: ChromRegistry, frag_len: float,
                        genome_len: int, verbose: bool
                        ) -> Dict[int, Pileup]:
    """savePileupNoCtrl (Genrich.c:1883-1896)."""
    lam = _calc_lambda(registry, frag_len, genome_len)
    if verbose:
        warn(f"  Background pileup value: {fmt_f(lam)}\n")
    out: Dict[int, Pileup] = {}
    for c in registry:
        if c.skip or not c.save:
            continue
        out[c.index] = lambda_pileup(c.length, c.bed, lam)
    return out


def _replicate_jax(eng, registry: ChromRegistry,
                   expt_sink: EventSink,
                   ctrl_sink: Optional[EventSink], p: Params,
                   n: int, pvals: Dict[int, List[Optional[Pileup]]],
                   pile_stream, expt_name: str,
                   ctrl_name: Optional[str], full_device: bool,
                   archive: bool):
    """Device replicate computation (--engine jax, float32).

    Stage 1 builds coverage on device for every saved chromosome
    (arrays stay resident in HBM) and pulls back only the weighted
    fragment-length scalars; stage 2 applies the elementwise p-value
    kernel in place.  With ``full_device`` the results never leave the
    device here — ``_find_peaks_jax`` finishes (q-values + peak
    calling) on device.  Otherwise compact RLE pileups are pulled
    back for the exact host downstream (-f/-k logs, Fisher, -X).
    """
    genome_len = p.genome_len or _compute_genome_len(
        registry, lambda c: not c.skip and c.save)
    if not genome_len:
        raise fatal("", ERRGEN)

    if hasattr(eng, "prepare"):
        # one global event bucket + background program prewarm: every
        # chromosome pads to the same shapes, so each device stage
        # compiles/loads exactly once per run, concurrently.  Runs
        # per analysis — a serve process fed heterogeneous inputs
        # re-derives the shape policy each time (engines skip the
        # re-warm when the resulting shapes are unchanged, so a
        # steady serve workload costs nothing extra).
        max_ev = 1
        max_excl = 0
        max_len = 0
        for c in registry:
            if c.skip or not c.save:
                continue
            for sink in (expt_sink, ctrl_sink):
                ev = _chrom_events(sink, c.index) if sink else None
                if ev is not None:
                    max_ev = max(max_ev, len(ev[0]))
            max_excl = max(max_excl, len(c.bed) // 2)
            if c.length <= 0x7FFFFFFF:      # host-fallback chroms
                max_len = max(max_len, c.length)  # don't shape grids
        eng.prepare(max_ev, max_excl, float(p.pqvalue),
                    float(p.min_auc), int(p.min_len), int(p.max_gap),
                    bool(p.qval_opt), max_chrom_len=max_len)

    # submit every chromosome's upload+coverage program before
    # resolving any fragment scalar: uploads and device compute
    # pipeline across chromosomes instead of serializing on a
    # per-chromosome device round trip
    handles = []
    for c in registry:
        if c.skip or not c.save:
            continue
        if c.length > 0x7FFFFFFF and p.verbose:
            # device positions are int32 (PARITY.md): this chromosome
            # is routed through the exact host engine instead
            # (engine/host_fallback.py); everything else stays on
            # the device
            warn(f"Warning! {c.name} is longer than 2^31-1 bp; "
                 f"computing it on the host\n")
        ev = _chrom_events(expt_sink, c.index)
        cv = _chrom_events(ctrl_sink, c.index) if ctrl_sink else None
        handles.append(eng.coverage_chrom(c.index, ev, cv, c.bed,
                                          c.length))
    if hasattr(eng, "coverage_finish"):
        frag, ctrl_frag = eng.coverage_finish(handles)
    else:
        frag = sum(float(fe) for fe, _ in handles)
        ctrl_frag = sum(float(fc) for _, fc in handles)
    if frag == 0.0:
        raise fatal("", ERREXPT)
    lam = F32(frag / genome_len)
    factor = F32(1.0) if ctrl_frag == 0.0 else F32(frag / ctrl_frag)
    if p.verbose:
        warn(f"  Background pileup value: {fmt_f(lam)}\n")
        if ctrl_sink is not None:
            warn(f"  Scaling factor for control pileup: "
                 f"{fmt_f(factor)}\n")
    eng.stats_all(float(lam), float(factor))

    if full_device:
        if archive:
            eng.archive_replicate()
        return {}, {}

    if pile_stream is not None:
        writers.pile_header(pile_stream, expt_name, ctrl_name)
    expt_out: Dict[int, Pileup] = {}
    ctrl_out: Dict[int, Pileup] = {}
    for c in registry:
        if c.skip:
            continue
        lst = pvals.setdefault(c.index, [])
        while len(lst) < n:
            lst.append(None)
        if not c.save:
            lst.append(None)
            continue
        epu, cpu_, pu = eng.pvalue_pileups(c.index)
        expt_out[c.index] = epu
        ctrl_out[c.index] = cpu_
        lst.append(pu)
        if pile_stream is not None:
            starts = np.concatenate([[0], pu.end[:-1]])
            if isinstance(pile_stream, writers.RowLog) \
                    and pile_stream.pile_rows(c.name, starts, pu.end,
                                              epu.cov, cpu_.cov,
                                              pu.cov):
                continue
            for m in range(len(pu.end)):
                writers.pile_row(pile_stream, c.name, int(starts[m]),
                                 int(pu.end[m]), epu.cov[m],
                                 cpu_.cov[m], pu.cov[m])
    eng.release()
    return expt_out, ctrl_out


def _find_peaks_jax(registry: ChromRegistry, eng, p: Params,
                    out_stream) -> None:
    """findPeaks (Genrich.c:1076-1137) finished on device.

    Used when no -f/-k logs are requested and there is a single
    replicate: q-values and peak calling run on the device over the
    resident interval arrays; only compact peak records cross the
    link.  Verbose output mirrors find_peaks().
    """
    if eng._reps:
        eng.finalize_fisher()
    chroms = [c for c in registry if not c.skip and c.index
              in eng._chrom]
    genome_len = p.genome_len
    if not genome_len:
        genome_len = _compute_genome_len(
            registry, lambda c: not c.skip and c.index in eng._chrom)

    if p.verbose:
        warn("Peak-calling parameters:\n")
        warn(f"  Genome length: {_i64(genome_len)}bp\n")
        warn(f"  Significance threshold: -log({'q' if p.qval_opt else 'p'}"
             f") > {fmt_prec(p.pqvalue, 3)}\n")
        warn(f"  Min. AUC: {fmt_prec(p.min_auc, 3)}\n")
        if p.min_len:
            warn(f"  Min. peak length: {p.min_len}bp\n")
        warn(f"  Max. gap between sites: {p.max_gap}bp\n")

    if p.qval_opt:
        all_one = eng.qvalue_table(genome_len)
        if p.verbose and all_one:
            warn("Warning! All q-values are 1\n")

    count = 0
    peak_bp = 0
    # submit all chromosomes, then fetch: the per-chrom peak programs
    # pipeline on the device while the host is still dispatching
    submit = getattr(eng, "peaks_submit", None)
    handles = [None] * len(chroms)
    if submit is not None:
        handles = [submit(c.index, float(p.pqvalue),
                          float(p.min_auc), p.min_len, p.max_gap,
                          bool(p.qval_opt)) for c in chroms]
    for c, h in zip(chroms, handles):
        if submit is not None:
            res = eng.peaks_fetch(h) if h is not None else None
        else:
            res = eng.peaks_chrom(c.index, float(p.pqvalue),
                                  float(p.min_auc), p.min_len,
                                  p.max_gap, bool(p.qval_opt))
        if res is None:
            # candidate cap exceeded: host fallback for this chrom
            pu = eng.pval_pileup(c.index)
            qv_cov = None
            if p.qval_opt:
                uv, qv = eng._qtable_host
                qv_cov = qvalue.qval_pileup(pu, uv, qv).cov
            stat = qv_cov if p.qval_opt else pu.cov
            for pk in peaks_mod.call_peaks_chrom(
                    stat, pu.cov, qv_cov, pu.end, p.pqvalue,
                    p.min_auc, p.min_len, p.max_gap):
                writers.write_peak(out_stream, c.name, pk, count)
                count += 1
                peak_bp += pk.end - pk.start
            continue
        starts, ends, aucs, spv, sqv, spos = res
        for m in range(len(starts)):
            pk = peaks_mod.Peak(int(starts[m]), int(ends[m]),
                                aucs[m], spv[m],
                                sqv[m] if p.qval_opt else F32(SKIP),
                                int(spos[m]))
            writers.write_peak(out_stream, c.name, pk, count)
            count += 1
            peak_bp += pk.end - pk.start
    if p.verbose:
        warn(f"Peaks identified: {count} ({peak_bp}bp)\n")
    eng.release()


def _save_pval(registry: ChromRegistry, n: int,
               expt: Dict[int, Pileup], ctrl: Dict[int, Pileup],
               pvals: Dict[int, List[Optional[Pileup]]],
               pile_stream, expt_name: str,
               ctrl_name: Optional[str]) -> None:
    """savePval (Genrich.c:1720-1794) incl. the -k pileup log."""
    if pile_stream is not None:
        writers.pile_header(pile_stream, expt_name, ctrl_name)

    def _pval_one(c):
        ends, ev, cv = pvalue.merge_pileups(expt[c.index],
                                            ctrl[c.index])
        pv, tab = pvalue.calc_pval_unique_tab(ends, ev, cv)
        return ends, ev, cv, pv, tab

    todo = [c for c in registry if not c.skip and c.save]
    results = {c.index: r for c, r in zip(todo,
                                          _par_map(_pval_one, todo))}
    for c in registry:
        if c.skip:
            continue
        lst = pvals.setdefault(c.index, [])
        while len(lst) < n:
            lst.append(None)
        if not c.save:
            lst.append(None)
            continue
        ends, ev, cv, pv, tab = results[c.index]
        lst.append(Pileup(ends, pv, tab=tab))
        if pile_stream is not None:
            starts = np.concatenate([[0], ends[:-1]])
            if isinstance(pile_stream, writers.RowLog) \
                    and pile_stream.pile_rows(c.name, starts, ends,
                                              ev, cv, pv):
                continue
            for m in range(len(ends)):
                writers.pile_row(pile_stream, c.name, int(starts[m]),
                                 int(ends[m]), ev[m], cv[m], pv[m])


def log_counts(counters: FileCounters, registry: ChromRegistry,
               p: Params, bam: bool) -> None:
    """logCounts (Genrich.c:5295-5374), byte-for-byte on stderr."""
    c = counters
    if c.err_count > MAX_ALNS:
        warn(f"(another {c.err_count - MAX_ALNS} warning messages "
             f"suppressed)\n")
    avg_len = c.total_len / c.paired_pr if c.paired_pr else 0.0
    warn(f"  {'BAM' if bam else 'SAM'} records analyzed: "
         f"{c.count:11d}\n")
    if c.unmapped:
        warn(f"    Unmapped:           {c.unmapped:11d}\n")
    if c.supp:
        warn(f"    Supp./dups/lowQual: {c.supp:11d}\n")
    if c.skipped:
        warn(f"    To skipped refs:    {c.skipped:11d}\n")
        names = [ch.name for ch in registry if ch.skip or not ch.save]
        warn("      (" + ",".join(names) + ")\n")
    if c.low_mapq:
        warn(f"    MAPQ < {p.min_mapq:<2d}:          {c.low_mapq:11d}\n")
    warn(f"    Paired alignments:  {c.paired:11d}\n")
    if c.sec_pair:
        warn(f"      secondary alns:   {c.sec_pair:11d}\n")
    if c.orphan:
        warn(f"      \"orphan\" alns:    {c.orphan:11d}"
             f"\t** Warning! **\n")
    warn(f"    Unpaired alignments:{c.single:11d}\n")
    if c.sec_single:
        warn(f"      secondary alns:   {c.sec_single:11d}\n")
    if p.dups_opt:
        warn("  PCR duplicates --\n")
        warn(f"    Paired aln sets:    {c.count_pr:11d}\n")
        pct = F32(F32(100.0) * F32(c.dups_pr) / F32(c.count_pr)) \
            if c.count_pr else F32(0.0)
        warn(f"      duplicates:       {c.dups_pr:11d} "
             f"({fmt_prec(pct, 1)}%)\n")
        if p.single_opt:
            warn(f"    Discordant aln sets:{c.count_dc:11d}\n")
            pct = F32(F32(100.0) * F32(c.dups_dc) / F32(c.count_dc)) \
                if c.count_dc else F32(0.0)
            warn(f"      duplicates:       {c.dups_dc:11d} "
                 f"({fmt_prec(pct, 1)}%)\n")
            warn(f"    Singleton aln sets: {c.count_sn:11d}\n")
            pct = F32(F32(100.0) * F32(c.dups_sn) / F32(c.count_sn)) \
                if c.count_sn else F32(0.0)
            warn(f"      duplicates:       {c.dups_sn:11d} "
                 f"({fmt_prec(pct, 1)}%)\n")
    warn(f"  Fragments analyzed:   {c.single_pr + c.paired_pr:11d}\n")
    warn(f"    Full fragments:     {c.paired_pr:11d}\n")
    if c.paired_pr and not p.atac_opt:
        warn(f"      (avg. length: {fmt_prec(avg_len, 1)}bp)\n")
    if p.single_opt:
        warn(f"    Half fragments:     {c.single_pr:11d}\n")
        if c.single_pr:
            msg = "      (from unpaired alns"
            if p.extend_opt:
                msg += f", extended to {p.extend}bp"
            elif p.avg_ext_opt and c.paired_pr:
                msg += f", extended to {int(avg_len + 0.5)}bp"
            warn(msg + ")\n")
    if p.atac_opt:
        warn(f"    ATAC-seq cut sites: "
             f"{2 * c.paired_pr + c.single_pr:11d}\n")
        warn(f"      (expanded to length "
             f"{p.atac_len5 + p.atac_len3}bp)\n")


def find_peaks(registry: ChromRegistry,
               pvals: Dict[int, List[Optional[Pileup]]],
               sample: int,
               expt: Dict[int, Pileup], ctrl: Dict[int, Pileup],
               out_stream, log_stream, p: Params) -> None:
    """findPeaks (Genrich.c:1076-1137)."""
    if sample > 1:
        for c in registry:
            if c.skip:
                continue
            lst = pvals.setdefault(c.index, [])
            while len(lst) < sample:
                lst.append(None)
            lst.append(chisq.combine_pvals(lst[:sample], c.length))
        n = sample
    else:
        n = sample - 1

    genome_len = p.genome_len
    genome_opt = False
    if not genome_len:
        genome_opt = True
        genome_len = _compute_genome_len(
            registry, lambda c: (not c.skip
                                 and pvals.get(c.index)
                                 and pvals[c.index][n] is not None))

    if p.verbose:
        if p.peaks_opt:
            warn("Peak-calling parameters:\n")
            warn(f"  Genome length: {_i64(genome_len)}bp\n")
            warn(f"  Significance threshold: -log({'q' if p.qval_opt else 'p'}"
                 f") > {fmt_prec(p.pqvalue, 3)}\n")
            warn(f"  Min. AUC: {fmt_prec(p.min_auc, 3)}\n")
            if p.min_len:
                warn(f"  Min. peak length: {p.min_len}bp\n")
            warn(f"  Max. gap between sites: {p.max_gap}bp\n")
        else:
            warn("- peak-calling skipped -\n")
            warn(f"  Genome length: {_i64(genome_len)}bp\n")

    # q-values
    qvals: Dict[int, Pileup] = {}
    if p.qval_opt:
        final = [pvals[c.index][n] for c in registry
                 if not c.skip and pvals.get(c.index)
                 and pvals[c.index][n] is not None]
        pd, pl = qvalue.collect_pvals(final)
        if genome_opt and int(pl.sum()) != genome_len:
            raise fatal(f"Genome length ({genome_len}) does not match "
                        f"p-value length ({int(pl.sum())})", ERRISSUE)
        qv = qvalue.qvalues(pd, pl, genome_len)
        for c in registry:
            if c.skip or not pvals.get(c.index) \
                    or pvals[c.index][n] is None:
                continue
            qvals[c.index] = qvalue.qval_pileup(pvals[c.index][n],
                                                pd, qv)
        if p.verbose and qvalue.all_qvalues_one(qv):
            warn("Warning! All q-values are 1\n")

    if p.peaks_opt:
        _call_peaks(registry, pvals, qvals, n, expt, ctrl, out_stream,
                    log_stream, p)
    elif log_stream is not None:
        _log_intervals(registry, pvals, qvals, n, expt, ctrl,
                       log_stream, p)


def _iter_log_rows(registry, pvals, qvals, n, expt, ctrl, p,
                   need_cov: bool = True):
    """Yield per-interval rows shared by callPeaks/logIntervals -f logs.

    ``need_cov=False`` (peak calling without a -f log) skips the
    expt/ctrl/replicate searchsorted gathers — at 146M records those
    are ~5 s of work whose results would never be read."""
    for c in registry:
        if c.skip:
            continue
        if p.qval_opt:
            if qvals.get(c.index) is None:
                continue
        elif not pvals.get(c.index) or pvals[c.index][n] is None:
            continue
        pv = pvals[c.index][n]
        qv = qvals.get(c.index)
        ends = pv.end
        starts = np.concatenate([[0], ends[:-1]])
        if not need_cov:
            yield c, pv, qv, starts, ends, None, None, None
            continue
        if n == 0:
            e = expt[c.index]
            ct = ctrl[c.index]
            ev = e.cov[np.searchsorted(e.end, ends, side="left")]
            cv = ct.cov[np.searchsorted(ct.end, ends, side="left")]
            reps = None
        else:
            ev = cv = None
            reps = []
            for r in range(n):
                rp = pvals[c.index][r] if r < len(pvals[c.index]) \
                    else None
                if rp is None:
                    reps.append(None)
                else:
                    reps.append(rp.cov[np.searchsorted(
                        rp.end, ends, side="left")])
        yield c, pv, qv, starts, ends, ev, cv, reps


def _write_log_row(log_stream, c, m, starts, ends, ev, cv, reps, pv,
                   qv, p, n, sig):
    qval = qv.cov[m] if qv is not None else SKIP
    if n == 0:
        writers.log_interval(log_stream, c.name, int(starts[m]),
                             int(ends[m]), ev[m], cv[m], pv.cov[m],
                             p.qval_opt, qval, sig)
    else:
        rep_vals = [r[m] if r is not None else None for r in reps]
        writers.log_interval_n(log_stream, c.name, int(starts[m]),
                               int(ends[m]), rep_vals, pv.cov[m],
                               p.qval_opt, qval, sig)


def _call_peaks(registry, pvals, qvals, n, expt, ctrl, out_stream,
                log_stream, p) -> None:
    """callPeaks (Genrich.c:977-1069) + the significance-flagged log."""
    if log_stream is not None:
        writers.log_header(log_stream, n, p.qval_opt, True)
    count = 0
    peak_bp = 0
    for (c, pv, qv, starts, ends, ev, cv,
         reps) in _iter_log_rows(registry, pvals, qvals, n, expt,
                                 ctrl, p,
                                 need_cov=log_stream is not None):
        stat = qv.cov if p.qval_opt else pv.cov
        chrom_peaks = peaks_mod.call_peaks_chrom(
            stat, pv.cov, qv.cov if qv is not None else None, ends,
            p.pqvalue, p.min_auc, p.min_len, p.max_gap)
        for pk in chrom_peaks:
            writers.write_peak(out_stream, c.name, pk, count)
            count += 1
            peak_bp += pk.end - pk.start
        if log_stream is not None:
            sig_mask = stat > F32(p.pqvalue)
            if n == 0 and isinstance(log_stream, writers.RowLog) \
                    and log_stream.log_rows(
                        c.name, starts, ends, ev, cv, pv.cov,
                        qv.cov if p.qval_opt and qv is not None
                        else None, sig_mask):
                continue
            for m in range(len(ends)):
                _write_log_row(log_stream, c, m, starts, ends, ev, cv,
                               reps, pv, qv, p, n, bool(sig_mask[m]))
    if p.verbose:
        warn(f"Peaks identified: {count} ({peak_bp}bp)\n")


def _log_intervals(registry, pvals, qvals, n, expt, ctrl, log_stream,
                   p) -> None:
    """logIntervals (Genrich.c:837-878): stats log without peaks."""
    writers.log_header(log_stream, n, p.qval_opt, False)
    for (c, pv, qv, starts, ends, ev, cv,
         reps) in _iter_log_rows(registry, pvals, qvals, n, expt,
                                 ctrl, p):
        if n == 0 and isinstance(log_stream, writers.RowLog) \
                and log_stream.log_rows(
                    c.name, starts, ends, ev, cv, pv.cov,
                    qv.cov if p.qval_opt and qv is not None
                    else None, None):
            continue
        for m in range(len(ends)):
            _write_log_row(log_stream, c, m, starts, ends, ev, cv,
                           reps, pv, qv, p, n, False)


def run(p: Params, engine=None, perf: Optional[dict] = None
        ) -> None:
    """runProgram (Genrich.c:5386-5695).

    ``engine``: optional pre-built device engine (JaxEngine /
    ShardedEngine) to reuse across runs — the serve mode
    (genrich_tpu/serve.py) passes one so compiled XLA programs load
    once per process instead of once per analysis.  Engines clear
    their per-run state in ``release()``; the jitted programs persist.

    ``perf``: optional dict; filled with the stage-wall decomposition
    {ingest_s, device_rep_s, findpeaks_s, ...} plus the engine's
    upload/dispatch/fetch accounting (bench protocol).
    """
    if p.peaks_only:
        from .logreader import find_peaks_only
        find_peaks_only(p)
        return

    xbed = load_bed(p.x_file) if p.x_file else []
    registry = ChromRegistry(p.xchr_list, xbed, p.verbose)

    expt_files = _split_files(p.in_file)
    ctrl_files = _split_files(p.ctrl_file)

    # native C++ ingest: default when all inputs are regular files
    # (stdin needs the Python reader); the library is built on first
    # use, and under auto a library that cannot be built or loaded
    # falls back to the Python ingest with a warning
    nat = None
    if p.ingest in ("auto", "native") \
            and "-" not in expt_files + ctrl_files:
        from .ingest import native as native_mod
        try:
            nat = native_mod.NativeIngest(p, xbed)
        except native_mod.NativeUnavailable as exc:
            if p.ingest == "native":
                raise fatal(f"native ingest library unavailable "
                            f"({exc})", ERRGEN)
            warn(f"Warning! {exc}; using the Python ingest\n")
    if perf is not None:
        perf["ingest"] = "native" if nat is not None else "python"

    if nat is not None:
        bed_stream = None
        dups_stream = None
        # truncate the incrementally-appended logs
        for path in (p.bed_file,
                     p.dups_file if p.dups_opt else None):
            if path:
                real = files.resolve_out_path(path, p.gz_out)
                open(real, "w").close()
    else:
        bed_stream = files.open_write(p.bed_file, p.gz_out) \
            if p.bed_file else None
        dups_stream = files.open_write(p.dups_file, p.gz_out) \
            if p.dups_opt and p.dups_file else None
    def _row_stream(path):
        if path is None:
            return None
        if nat is not None and path != "-":
            return writers.RowLog(path, p.gz_out)
        return files.open_write(path, p.gz_out)

    pile_stream = _row_stream(p.pile_file)

    pvals: Dict[int, List[Optional[Pileup]]] = {}
    expt_pu: Dict[int, Pileup] = {}
    ctrl_pu: Dict[int, Pileup] = {}
    jax_engine = None
    full_device = False
    if p.engine == "jax":
        from .engine.jax_bridge import JaxEngine
        jax_engine = engine if engine is not None else JaxEngine()
    elif p.engine == "sharded":
        from .engine.sharded_bridge import ShardedEngine
        jax_engine = engine if engine is not None else ShardedEngine()
    if jax_engine is not None:
        if hasattr(jax_engine, "begin_run"):
            jax_engine.begin_run()    # reset per-analysis accounting
        # with no interval logs, the analysis finishes on the device:
        # Fisher combination, q-values, and peak calling over
        # resident arrays
        full_device = (p.peaks_opt and not p.log_file
                       and not p.pile_file)

    sample = 0
    for si, expt_name in enumerate(expt_files):
        registry.reset_save_flags()
        if nat is not None:
            nat.reset_save()
        ctrl_name = ctrl_files[si] if si < len(ctrl_files) else None
        frag_len = 0.0
        sinks: List[Optional[EventSink]] = [None, None]
        for i in (0, 1):
            filename = expt_name
            if i:
                filename = None if (ctrl_name is None
                                    or ctrl_name == "null") \
                    else ctrl_name
                if filename is None:
                    if p.verbose:
                        warn(f"- control file #{sample} not "
                             f"provided -\n")
                    if jax_engine is None:
                        ctrl_pu = _save_pileup_noctrl(
                            registry, frag_len, p.genome_len,
                            p.verbose)
                    break
            if p.verbose:
                warn(f"Processing {'control' if i else 'experimental'}"
                     f" file #{sample}: {filename}\n")
            hdr = (f"# {'control' if i else 'experimental'} file "
                   f"#{sample}: {filename}\n")
            sink = EventSink()
            with stage(f"parse {filename}", perf, "ingest_s"):
                if nat is not None:
                    if p.dups_opt and p.dups_file:
                        _append_text(p.dups_file, p.gz_out, hdr)
                    counters = _parse_file_native(
                        nat, filename, registry, p, sink, bool(i),
                        sample)
                    bam = _is_bam(filename)
                else:
                    if dups_stream is not None:
                        dups_stream.write(hdr)
                    counters, writer, bam = _parse_file(
                        filename, registry, p, sink, bed_stream,
                        dups_stream, bool(i), sample)
                    counters.err_count = writer.err_count
            if p.verbose:
                log_counts(counters, registry, p, bam)
            sinks[i] = sink
            if jax_engine is not None:
                continue
            if i:
                with stage("pileup ctrl"):
                    ctrl_pu = _save_pileup_ctrl(
                        registry, sink, frag_len, p.genome_len,
                        p.verbose)
            else:
                with stage("pileup expt"):
                    expt_pu, frag_len = _save_pileup_expt(registry,
                                                          sink)

        if jax_engine is not None:
            with stage("device pileup+p-values", perf,
                       "device_rep_s"):
                expt_pu, ctrl_pu = _replicate_jax(
                    jax_engine, registry, sinks[0], sinks[1], p,
                    sample, pvals, pile_stream, expt_name, ctrl_name,
                    full_device,
                    archive=(len(expt_files) > 1))
        else:
            with stage("p-values"):
                _save_pval(registry, sample, expt_pu, ctrl_pu, pvals,
                           pile_stream, expt_name, ctrl_name)
        sample += 1

    out_stream = files.open_write(p.out_file, p.gz_out) \
        if p.peaks_opt else None
    log_stream = _row_stream(p.log_file)

    with stage("findPeaks", perf, "findpeaks_s"):
        if full_device:
            _find_peaks_jax(registry, jax_engine, p, out_stream)
        else:
            find_peaks(registry, pvals, sample, expt_pu, ctrl_pu,
                       out_stream, log_stream, p)

    if perf is not None and jax_engine is not None \
            and hasattr(jax_engine, "perf"):
        perf.update(jax_engine.perf)

    for s in (out_stream, log_stream, pile_stream, bed_stream,
              dups_stream):
        if s is not None and s is not sys.stdout:
            s.close()
