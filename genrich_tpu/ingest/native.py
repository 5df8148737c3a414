"""ctypes bindings for the native C++ ingest library.

Wraps native/libgenrich_ingest.so (SAM/BAM parsing, pair assembly,
multimapper selection, PCR dedup, interval generation — the byte-level
host pipeline).  The library produces per-chromosome event arrays and
counters identical to the pure-Python ingest; tests assert equality.

The shared object is never committed: it is built from
native/ingest.cpp with make at first use, and rebuilt whenever the
sources' hash differs from the one recorded beside the binary.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import time
from typing import List, Optional, Tuple

import numpy as np

from ..errors import GenrichError
from ..params import Params

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO, "native")
SO_NAME = "libgenrich_ingest.so"
_SOURCES = ("ingest.cpp", "Makefile")
_STAMP = ".build.sha256"      # hash of the sources the .so was built from

_lib = None
_load_error: Optional["NativeUnavailable"] = None


class NativeUnavailable(RuntimeError):
    """The native library could not be built or loaded."""


def _source_hash(native_dir: str) -> str:
    h = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(native_dir, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _is_current(native_dir: str, want: str) -> bool:
    try:
        with open(os.path.join(native_dir, _STAMP)) as f:
            stamp = f.read().strip()
    except OSError:
        return False
    return stamp == want and os.path.exists(
        os.path.join(native_dir, SO_NAME))


def build(native_dir: str = NATIVE_DIR) -> float:
    """Build the library from source unless it is current.

    Returns the seconds spent building (0.0 when the recorded source
    hash already matches).  Concurrent callers (xdist workers, several
    CLI processes) serialize on a file lock; the build goes to a
    temporary name and is renamed into place, so no process ever loads
    a half-written file.
    """
    want = _source_hash(native_dir)
    if _is_current(native_dir, want):
        return 0.0
    with open(os.path.join(native_dir, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _is_current(native_dir, want):
            return 0.0      # another process built it while we waited
        tmp = f".build.{os.getpid()}.so"
        t0 = time.perf_counter()
        try:
            subprocess.run(["make", "-s", "-B", "-C", native_dir,
                            f"TARGET={tmp}"],
                           check=True, capture_output=True, text=True)
            os.replace(os.path.join(native_dir, tmp),
                       os.path.join(native_dir, SO_NAME))
        except (OSError, subprocess.CalledProcessError) as exc:
            detail = (getattr(exc, "stderr", "") or str(exc)).strip()
            raise NativeUnavailable(
                f"building {SO_NAME} failed: "
                f"{(detail.splitlines() or [''])[-1]}") from exc
        finally:
            if os.path.exists(os.path.join(native_dir, tmp)):
                os.unlink(os.path.join(native_dir, tmp))
        stamp_tmp = os.path.join(native_dir, f".build.{os.getpid()}.sha")
        with open(stamp_tmp, "w") as f:
            f.write(want + "\n")
        os.replace(stamp_tmp, os.path.join(native_dir, _STAMP))
        return time.perf_counter() - t0


def available() -> bool:
    """True if the native library is loadable (building if needed)."""
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def _load():
    """The loaded library; builds it first if missing or stale.

    A failure is remembered, so callers that probe the library per
    call (the numeric helpers below) do not retry a failed build."""
    global _lib, _load_error
    if _lib is not None:
        return _lib
    if _load_error is not None:
        raise _load_error
    try:
        build()
        lib = ctypes.CDLL(os.path.join(NATIVE_DIR, SO_NAME))
        _bind_core(lib)
    except NativeUnavailable as exc:
        _load_error = exc
        raise
    except (OSError, AttributeError) as exc:
        _load_error = NativeUnavailable(f"loading {SO_NAME}: {exc}")
        raise _load_error from exc
    _lib = lib
    return lib


def _bind_core(lib) -> None:
    """argtypes/restype of the ingest entry points."""
    lib.gi_create.restype = ctypes.c_void_p
    lib.gi_error_msg.restype = ctypes.c_char_p
    lib.gi_error_msg.argtypes = [ctypes.c_void_p]
    lib.gi_error_code.restype = ctypes.c_int
    lib.gi_error_code.argtypes = [ctypes.c_void_p]
    lib.gi_destroy.argtypes = [ctypes.c_void_p]
    lib.gi_add_xchr.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.gi_add_xbed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_uint32, ctypes.c_uint32]
    lib.gi_set_options.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int32,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.gi_reset_save.argtypes = [ctypes.c_void_p]
    lib.gi_parse.restype = ctypes.c_int64
    lib.gi_parse.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_char_p, ctypes.c_int,
                             ctypes.c_char_p, ctypes.c_int]
    lib.gi_chrom_count.restype = ctypes.c_int
    lib.gi_chrom_count.argtypes = [ctypes.c_void_p]
    lib.gi_chrom_name.restype = ctypes.c_char_p
    lib.gi_chrom_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gi_chrom_len.restype = ctypes.c_uint32
    lib.gi_chrom_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gi_chrom_skip.restype = ctypes.c_int
    lib.gi_chrom_skip.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gi_chrom_save.restype = ctypes.c_int
    lib.gi_chrom_save.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gi_chrom_bed_len.restype = ctypes.c_int
    lib.gi_chrom_bed_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gi_chrom_bed.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_uint32)]
    lib.gi_event_count.restype = ctypes.c_int64
    lib.gi_event_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gi_events.argtypes = [ctypes.c_void_p, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_int64),
                              ctypes.POINTER(ctypes.c_int64),
                              ctypes.POINTER(ctypes.c_int32)]
    lib.gi_counters.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_uint64),
                                ctypes.POINTER(ctypes.c_double)]


def call_peaks_native(stat, pval, qval, ends, min_pq, min_auc,
                      min_len: int, max_gap: int):
    """Native exact-f32 peak caller (gi_call_peaks), or None if the
    library is absent.  Returns parallel numpy arrays
    (start, end, auc, summit_pval, summit_qval, summit_pos)."""
    try:
        lib = _load()
        if not hasattr(lib, "_peaks_ready"):
            pf = ctypes.POINTER(ctypes.c_float)
            p64 = ctypes.POINTER(ctypes.c_int64)
            lib.gi_call_peaks.restype = ctypes.c_int64
            lib.gi_call_peaks.argtypes = [
                pf, pf, pf, p64, ctypes.c_int64, ctypes.c_float,
                ctypes.c_float, ctypes.c_int64, ctypes.c_int64,
                p64, p64, pf, pf, pf, p64, ctypes.c_int64]
            lib._peaks_ready = True
    except (NativeUnavailable, AttributeError):
        return None
    stat = np.ascontiguousarray(stat, np.float32)
    pval = np.ascontiguousarray(pval, np.float32)
    ends = np.ascontiguousarray(ends, np.int64)
    n = len(stat)
    sig = stat > np.float32(min_pq)
    cap = int(np.count_nonzero(sig[1:] & ~sig[:-1])
              + (1 if n and sig[0] else 0))
    pf = ctypes.POINTER(ctypes.c_float)
    p64 = ctypes.POINTER(ctypes.c_int64)
    if cap == 0:
        z = np.zeros(0, np.float32)
        return (np.zeros(0, np.int64), np.zeros(0, np.int64), z, z,
                z, np.zeros(0, np.int64))
    o_start = np.empty(cap, np.int64)
    o_end = np.empty(cap, np.int64)
    o_auc = np.empty(cap, np.float32)
    o_spv = np.empty(cap, np.float32)
    o_sqv = np.empty(cap, np.float32)
    o_spos = np.empty(cap, np.int64)
    qarr = (np.ascontiguousarray(qval, np.float32)
            if qval is not None else None)   # keep the buffer alive
    qptr = qarr.ctypes.data_as(pf) if qarr is not None else None
    got = lib.gi_call_peaks(
        stat.ctypes.data_as(pf), pval.ctypes.data_as(pf), qptr,
        ends.ctypes.data_as(p64), n, np.float32(min_pq),
        np.float32(min_auc), int(min_len), int(max_gap),
        o_start.ctypes.data_as(p64), o_end.ctypes.data_as(p64),
        o_auc.ctypes.data_as(pf), o_spv.ctypes.data_as(pf),
        o_sqv.ctypes.data_as(pf), o_spos.ctypes.data_as(p64),
        cap)
    assert got <= cap, (got, cap)
    return (o_start[:got], o_end[:got], o_auc[:got], o_spv[:got],
            o_sqv[:got], o_spos[:got])


def call_peaks_log_native(path: str, idx_p: int, idx_q: int,
                          use_q: bool, min_pq, min_auc,
                          min_len: int, max_gap: int,
                          genome_opt: bool):
    """Native -P fast path (gi_call_peaks_log), or None when the
    library is absent or the log needs the Python state machine
    (anomalous rows, post-hoc exclusions are gated by the caller).

    Returns (names, sec, start, end, auc, spv, sqv, spos,
    genome_len, peak_bp)."""
    try:
        lib = _load()
        if not hasattr(lib, "_log_ready"):
            pf = ctypes.POINTER(ctypes.c_float)
            p64 = ctypes.POINTER(ctypes.c_int64)
            p32 = ctypes.POINTER(ctypes.c_int32)
            lib.gi_call_peaks_log.restype = ctypes.c_int64
            lib.gi_call_peaks_log.argtypes = [
                ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
            lib.gi_log_section_count.restype = ctypes.c_int32
            lib.gi_log_section_name.restype = ctypes.c_char_p
            lib.gi_log_section_name.argtypes = [ctypes.c_int32]
            lib.gi_log_peaks_fetch.argtypes = [
                p32, p64, p64, pf, pf, pf, p64, p64, p64]
            lib._log_ready = True
    except (NativeUnavailable, AttributeError):
        return None
    got = lib.gi_call_peaks_log(
        path.encode(), idx_p, idx_q, int(use_q),
        np.float32(min_pq), np.float32(min_auc), int(min_len),
        int(max_gap), int(genome_opt))
    if got < 0:
        return None
    n = int(got)
    sec = np.empty(max(n, 1), np.int32)
    start = np.empty(max(n, 1), np.int64)
    end = np.empty(max(n, 1), np.int64)
    auc = np.empty(max(n, 1), np.float32)
    spv = np.empty(max(n, 1), np.float32)
    sqv = np.empty(max(n, 1), np.float32)
    spos = np.empty(max(n, 1), np.int64)
    glen = ctypes.c_int64()
    pbp = ctypes.c_int64()
    pf = ctypes.POINTER(ctypes.c_float)
    p64 = ctypes.POINTER(ctypes.c_int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    lib.gi_log_peaks_fetch(
        sec.ctypes.data_as(p32), start.ctypes.data_as(p64),
        end.ctypes.data_as(p64), auc.ctypes.data_as(pf),
        spv.ctypes.data_as(pf), sqv.ctypes.data_as(pf),
        spos.ctypes.data_as(p64), ctypes.byref(glen),
        ctypes.byref(pbp))
    names = [lib.gi_log_section_name(i).decode()
             for i in range(lib.gi_log_section_count())]
    return (names, sec[:n], start[:n], end[:n], auc[:n], spv[:n],
            sqv[:n], spos[:n], int(glen.value), int(pbp.value))


def _rowlog_lib():
    try:
        lib = _load()
        if not hasattr(lib, "_rows_ready"):
            pf = ctypes.POINTER(ctypes.c_float)
            p64 = ctypes.POINTER(ctypes.c_int64)
            pu8 = ctypes.POINTER(ctypes.c_uint8)
            lib.gi_append_text.restype = ctypes.c_int64
            lib.gi_append_text.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                           ctypes.c_char_p,
                                           ctypes.c_int64]
            lib.gi_write_log_rows.restype = ctypes.c_int64
            lib.gi_write_log_rows.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                p64, p64, pf, pf, pf, pf, pu8, ctypes.c_int64]
            lib.gi_write_pile_rows.restype = ctypes.c_int64
            lib.gi_write_pile_rows.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                p64, p64, pf, pf, pf, ctypes.c_int64]
            lib._rows_ready = True
    except (NativeUnavailable, AttributeError):
        return None
    return lib


def append_text(path: str, gz: bool, text: str) -> bool:
    lib = _rowlog_lib()
    if lib is None:
        return False
    data = text.encode()
    return lib.gi_append_text(path.encode(), int(gz), data,
                              len(data)) == 0


def write_log_rows(path: str, gz: bool, name: str, starts, ends,
                   expt, ctrl, pval, qval, sig) -> bool:
    """Bulk -f rows (printInterval formats); False if lib absent."""
    lib = _rowlog_lib()
    if lib is None:
        return False
    pf = ctypes.POINTER(ctypes.c_float)
    p64 = ctypes.POINTER(ctypes.c_int64)
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    expt = np.ascontiguousarray(expt, np.float32)
    ctrl = np.ascontiguousarray(ctrl, np.float32)
    pval = np.ascontiguousarray(pval, np.float32)
    qarr = (np.ascontiguousarray(qval, np.float32)
            if qval is not None else None)
    sarr = (np.ascontiguousarray(sig, np.uint8)
            if sig is not None else None)
    return lib.gi_write_log_rows(
        path.encode(), int(gz), name.encode(),
        starts.ctypes.data_as(p64), ends.ctypes.data_as(p64),
        expt.ctypes.data_as(pf), ctrl.ctypes.data_as(pf),
        pval.ctypes.data_as(pf),
        qarr.ctypes.data_as(pf) if qarr is not None else None,
        sarr.ctypes.data_as(pu8) if sarr is not None else None,
        len(starts)) == 0


def write_pile_rows(path: str, gz: bool, name: str, starts, ends,
                    expt, ctrl, pval) -> bool:
    """Bulk -k rows (printPile formats); False if lib absent."""
    lib = _rowlog_lib()
    if lib is None:
        return False
    pf = ctypes.POINTER(ctypes.c_float)
    p64 = ctypes.POINTER(ctypes.c_int64)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    expt = np.ascontiguousarray(expt, np.float32)
    ctrl = np.ascontiguousarray(ctrl, np.float32)
    pval = np.ascontiguousarray(pval, np.float32)
    return lib.gi_write_pile_rows(
        path.encode(), int(gz), name.encode(),
        starts.ctypes.data_as(p64), ends.ctypes.data_as(p64),
        expt.ctypes.data_as(pf), ctrl.ctypes.data_as(pf),
        pval.ctypes.data_as(pf), len(starts)) == 0


def breakpoints(start, end, count):
    """Native sorted nonzero-entry positions + canonical f32 values.

    Returns (upos int64, vals float32), or None if lib absent.
    Identical integer/float32 math to engine.pileup._nonzero_entries
    + canon_value_f32 (getVal, Genrich.c:1902-1907).
    """
    import numpy as np
    try:
        lib = _load()
        if not hasattr(lib, "_bp_ready"):
            p64 = ctypes.POINTER(ctypes.c_int64)
            p32 = ctypes.POINTER(ctypes.c_int32)
            pf = ctypes.POINTER(ctypes.c_float)
            lib.gi_breakpoints_arrays.restype = ctypes.c_int64
            lib.gi_breakpoints_arrays.argtypes = [p64, p64, p32,
                                                  ctypes.c_int64]
            lib.gi_breakpoints_fetch.argtypes = [ctypes.c_void_p, p64, pf]
            lib._bp_ready = True
    except (NativeUnavailable, AttributeError):
        return None
    s = np.ascontiguousarray(start, np.int64)
    e = np.ascontiguousarray(end, np.int64)
    c = np.ascontiguousarray(count, np.int32)
    p64 = ctypes.POINTER(ctypes.c_int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    pf = ctypes.POINTER(ctypes.c_float)
    n = lib.gi_breakpoints_arrays(s.ctypes.data_as(p64),
                                  e.ctypes.data_as(p64),
                                  c.ctypes.data_as(p32), len(s))
    upos = np.empty(n, np.int64)
    vals = np.empty(n, np.float32)
    lib.gi_breakpoints_fetch(None, upos.ctypes.data_as(p64),
                             vals.ctypes.data_as(pf))
    return upos, vals


def exact_sum_f32(terms) -> Optional[float]:
    """Sequential double += float reduction in C; None if lib absent."""
    import numpy as np
    try:
        lib = _load()
        if not hasattr(lib, "_sum_ready"):
            lib.gi_exact_sum_f32.restype = ctypes.c_double
            lib.gi_exact_sum_f32.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
            lib._sum_ready = True
    except (NativeUnavailable, AttributeError):
        return None
    t = np.ascontiguousarray(terms, np.float32)
    return lib.gi_exact_sum_f32(
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(t))


def pair_index_tab(keys, uk, ends):
    """Fused distinct-pair row index + per-pair bp totals in C.

    ``keys`` are per-RLE-row packed (expt, ctrl) u64s, ``uk`` their
    sorted distinct table (np.unique(keys)), ``ends`` the int64 row
    end coordinates.  Returns (idx uint32, bp float64[d]) with
    uk[idx] == keys and bp[j] the summed interval length of pair j —
    the savePval row mapping plus the hashPval BH histogram terms
    (Genrich.c:1720-1794, 300-327) in one pass.  None if the library
    is absent or a key is missing from uk (caller falls back to
    numpy's searchsorted/bincount).
    """
    import numpy as np
    try:
        lib = _load()
        if not hasattr(lib, "_pit_ready"):
            pu64 = ctypes.POINTER(ctypes.c_uint64)
            lib.gi_pair_index_tab.restype = ctypes.c_int
            lib.gi_pair_index_tab.argtypes = [
                pu64, ctypes.c_int64, pu64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_double)]
            lib._pit_ready = True
    except (NativeUnavailable, AttributeError):
        return None
    k = np.ascontiguousarray(keys, np.uint64)
    u = np.ascontiguousarray(uk, np.uint64)
    e = np.ascontiguousarray(ends, np.int64)
    idx = np.empty(len(k), np.uint32)
    bp = np.empty(len(u), np.float64)
    pu64 = ctypes.POINTER(ctypes.c_uint64)
    rc = lib.gi_pair_index_tab(
        k.ctypes.data_as(pu64), len(k), u.ctypes.data_as(pu64),
        len(u), e.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        bp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        return None
    return idx, bp


def log10f_arr_native(x) -> Optional["np.ndarray"]:
    """Elementwise libm log10f in C; None if lib absent."""
    import numpy as np
    try:
        lib = _load()
        if not hasattr(lib, "_log10f_ready"):
            lib.gi_log10f.argtypes = [ctypes.POINTER(ctypes.c_float),
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_int64]
            lib._log10f_ready = True
    except (NativeUnavailable, AttributeError):
        return None
    xin = np.ascontiguousarray(x, np.float32)
    out = np.empty(xin.shape, np.float32)
    lib.gi_log10f(
        xin.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        xin.size)
    return out


_COUNTER_FIELDS = ("count", "unmapped", "paired", "single", "orphan",
                   "paired_pr", "single_pr", "supp", "skipped",
                   "low_mapq", "sec_pair", "sec_single", "count_pr",
                   "dups_pr", "count_dc", "dups_dc", "count_sn",
                   "dups_sn", "err_count")


class NativeIngest:
    """A persistent native parsing context (chrom registry survives
    across files, as in the reference's runProgram loop)."""

    def __init__(self, p: Params,
                 xbed: List[Tuple[str, int, int]]):
        self._lib = _load()
        self._h = self._lib.gi_create()
        for name in p.xchr_list:
            self._lib.gi_add_xchr(self._h, name.encode())
        for (name, p0, p1) in xbed:
            self._lib.gi_add_xbed(self._h, name.encode(), p0, p1)
        self._lib.gi_set_options(
            self._h, p.single_opt, p.extend_opt, p.extend,
            p.avg_ext_opt, p.atac_opt, p.atac_adj, p.atac_len5,
            p.atac_len3, p.min_mapq, float(p.as_diff), p.dups_opt,
            p.sort_opt, p.verbose)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.gi_destroy(self._h)
            self._h = None

    def reset_save(self) -> None:
        self._lib.gi_reset_save(self._h)

    def parse(self, path: str, ctrl: bool, sample: int,
              bed_path: Optional[str], dups_path: Optional[str],
              gz_out: bool) -> int:
        n = self._lib.gi_parse(
            self._h, path.encode(), 0, int(ctrl), sample,
            (bed_path or "").encode(), int(gz_out),
            (dups_path or "").encode(), int(gz_out))
        if n < 0:
            code = self._lib.gi_error_code(self._h)
            msg = self._lib.gi_error_msg(self._h).decode()
            raise GenrichError(msg, code)
        return n

    def chroms(self):
        """[(name, length, skip, save, bed_list)] in registry order."""
        out = []
        for i in range(self._lib.gi_chrom_count(self._h)):
            nbed = self._lib.gi_chrom_bed_len(self._h, i)
            bed = (ctypes.c_uint32 * max(nbed, 1))()
            if nbed:
                self._lib.gi_chrom_bed(self._h, i, bed)
            out.append((self._lib.gi_chrom_name(self._h, i).decode(),
                        self._lib.gi_chrom_len(self._h, i),
                        bool(self._lib.gi_chrom_skip(self._h, i)),
                        bool(self._lib.gi_chrom_save(self._h, i)),
                        list(bed[:nbed])))
        return out

    def events(self, chrom_index: int):
        n = self._lib.gi_event_count(self._h, chrom_index)
        if n == 0:
            return None
        start = np.empty(n, np.int64)
        end = np.empty(n, np.int64)
        count = np.empty(n, np.int32)
        self._lib.gi_events(
            self._h, chrom_index,
            start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            end.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            count.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return start, end, count

    def counters(self):
        u = (ctypes.c_uint64 * len(_COUNTER_FIELDS))()
        t = ctypes.c_double()
        self._lib.gi_counters(self._h, u, ctypes.byref(t))
        vals = dict(zip(_COUNTER_FIELDS, u))
        vals["total_len"] = t.value
        return vals
