"""Smoke run of the served peak-calling path on an NVIDIA GPU.

Shows, on a machine with a card, that the system's main path runs and
gives the right answer at whole-human-genome scale.  Phases, in order
(any failure exits non-zero before the result line):

  1. device   JAX, held to CUDA, finds a GPU; nvidia-smi reads the
              card's name and power limit, printed beside every number
  2. build    the native ingest library is built from native/ingest.cpp
  3. data     two seeded synthetic queryname-sorted BGZF ATAC BAMs over
              the 2.75 Gbp genome of scripts/bench_e2e.py (the second
              is the control and the second replicate) and an -E BED
  4. exact    ``--engine exact --ingest native`` on the CPU, for
              A: -r -j -q 0.05 -a 20
              B: A + -c b.bam -E excl.bed (8-channel tile, ctrl factor)
              C: -t a.bam,b.bam -q 0.05 -a 20 (on-device Fisher)
  5. served   one ``--serve`` process runs, per engine (jax, then
              sharded), A cold, A warm twice, B and C; every output is
              compared with the exact engine's (bench_e2e.verify_rows)
  6. kernels  one real-width tile (2^24 bp, 2^19 events per channel,
              control, 64 exclusion pairs) through tile_coverage ->
              tile_stats -> call_peaks, and fisher_combine, compared
              with the numpy engine; memory_analysis of each compiled
              stage; the lax chain cumsum -> canon_value -> calc_pval
              timed at 2^22 rows

Only one process uses the card at a time: this process stays off JAX
until the serve child has exited, then runs phase 6 itself.  The last
stdout line is ``{"ok": true, "device": {...}}`` for the device phase
6 ran on.

    python chip_smoke.py                  # one card, 2M pairs
    python chip_smoke.py --pairs 500000   # other input sizes
    python chip_smoke.py --gpus 4         # the sharded path on 4 cards

``--gpus N`` runs only the multi-card path: A and C through
``--serve --engine sharded`` with the mesh over all N cards, the same
on a 1-card mesh (CUDA_VISIBLE_DEVICES=0), both compared with the
exact engine and with each other, then
``__graft_entry__.dryrun_multichip(N)``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import math
import multiprocessing
import os
import random
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import bench_e2e  # noqa: E402
import perf_synth  # noqa: E402
from genrich_tpu.ingest import native  # noqa: E402

THRESH = -math.log10(0.05)          # the -q 0.05 cutoff of A, B, C
FLAGS_A = "-r -j -q 0.05 -a 20"


class SmokeFailure(RuntimeError):
    """A phase failed."""


class Report:
    """Prints each line with the card's name and power limit."""

    def __init__(self, card: str):
        self.card = card

    def say(self, msg: str) -> None:
        print(f"[{self.card}] {msg}", flush=True)


def child_env(platforms: str, extra=None) -> dict:
    env = dict(os.environ, JAX_PLATFORMS=platforms)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra or {})
    return env


# --- 1. device ----------------------------------------------------------

def device_info(platforms: str = "cuda") -> dict:
    """platform, kind and count of the devices JAX finds in a child
    process (this one stays off the card)."""
    code = ("import jax, json; d = jax.devices(); print(json.dumps("
            "{'platform': d[0].platform, 'kind': d[0].device_kind, "
            "'count': len(d)}))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=child_env(platforms), timeout=300)
    if r.returncode != 0:
        raise SmokeFailure(f"JAX found no device under JAX_PLATFORMS="
                           f"{platforms}: {r.stderr.strip()[-400:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def check_device(info: dict, count: int = 1) -> None:
    if info["platform"] != "gpu":
        raise SmokeFailure(f"expected a GPU, JAX reports {info}")
    if info["count"] < count:
        raise SmokeFailure(f"expected {count} GPUs, JAX reports {info}")


# --- 2. build -----------------------------------------------------------

def build_native(rep: Report) -> None:
    secs = native.build()
    if not native.available():
        raise SmokeFailure("the native ingest library does not load")
    with open("/proc/self/maps") as f:
        deflate = "libdeflate" in f.read()
    rep.say(f"native ingest: built in {secs:.1f} s"
            if secs else "native ingest: up to date, not rebuilt")
    rep.say(f"native ingest: libdeflate linked: {deflate}")


# --- 3. data ------------------------------------------------------------

def make_data(rep: Report, d: str, n_pairs: int, seed: int = 7,
              chroms=bench_e2e.HG_CHROMS) -> None:
    """a.bam (seed), b.bam (seed + 1) and excl.bed in ``d``."""
    t0 = time.perf_counter()
    synth = functools.partial(perf_synth.synth_bam, chroms=chroms)
    jobs = [(os.path.join(d, "a.bam"), n_pairs, seed),
            (os.path.join(d, "b.bam"), n_pairs, seed + 1)]
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        pool.starmap(synth, jobs)
    rng = random.Random(seed)
    with open(os.path.join(d, "excl.bed"), "w") as f:
        for name, length in chroms:
            for s in sorted(rng.sample(range(0, length - 10_000,
                                             10_000), 16)):
                f.write(f"{name}\t{s}\t{s + rng.randrange(500, 8000)}\n")
    rep.say(f"data: 2 BAMs x {n_pairs} pairs over "
            f"{sum(n for _, n in chroms)} bp in "
            f"{time.perf_counter() - t0:.1f} s")


def analyses(d: str) -> dict:
    a, b = os.path.join(d, "a.bam"), os.path.join(d, "b.bam")
    return {"A": f"-t {a} {FLAGS_A}",
            "B": f"-t {a} -c {b} -E {os.path.join(d, 'excl.bed')} "
                 f"{FLAGS_A}",
            "C": f"-t {a},{b} -q 0.05 -a 20"}


# --- 4. exact reference ---------------------------------------------------

def run_exact(rep: Report, d: str, names) -> None:
    """--engine exact for each analysis, in parallel, on the CPU."""
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        err = open(os.path.join(d, f"exact_{name}.err"), "w")
        cmd = ([sys.executable, "-m", "genrich_tpu"]
               + analyses(d)[name].split()
               + ["--engine", "exact", "--ingest", "native",
                  "-o", f"exact_{name}.np"])
        procs[name] = (subprocess.Popen(
            cmd, cwd=d, stdout=subprocess.DEVNULL, stderr=err,
            env=child_env("cpu")), err)
    failed = []
    try:
        for name, (proc, err) in procs.items():
            if proc.wait(timeout=1200) != 0:
                failed.append(name)
    finally:
        for proc, err in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            err.close()
    for name in failed:
        with open(os.path.join(d, f"exact_{name}.err")) as f:
            rep.say(f"exact {name} failed: {f.read()[-800:]}")
    if failed:
        raise SmokeFailure(f"exact engine failed on {failed}")
    rows = {n: _rows(os.path.join(d, f"exact_{n}.np")) for n in names}
    rep.say(f"exact engine: {rows} peaks in "
            f"{time.perf_counter() - t0:.1f} s (parallel)")


def _rows(path: str) -> int:
    with open(path) as f:
        return sum(1 for _ in f)


# --- 5. served path -------------------------------------------------------

def compare(rep: Report, d: str, out: str, ref: str, label: str,
            worst: dict) -> None:
    res = bench_e2e.verify_rows(os.path.join(d, ref),
                                os.path.join(d, out), THRESH)
    for k in ("worst_unmatched_margin", "worst_float_rel"):
        worst[k] = max(worst.get(k, 0.0), res[k])
    rep.say(f"compare {label} {out} vs {ref}: {json.dumps(res)}")
    if not res["ok"]:
        raise SmokeFailure(f"{out} disagrees with {ref}: {res}")
    if res["rows_ref"] == 0:
        raise SmokeFailure(f"{ref} has no peaks to compare")


def serve_phase(rep: Report, d: str, engines=("jax", "sharded"),
                plan=(("A", 0), ("A", 1), ("A", 2), ("B", 0), ("C", 0)),
                platforms: str = "cuda", expect_devices=None, env=None,
                tag: str = "", timeout: float = 900.0) -> dict:
    """Run ``plan`` per engine through one ``--serve`` process held to
    ``platforms`` and compare every output with
    ``exact_<analysis>.np``.  Returns the worst margins seen."""
    expect_platform = {"cuda": "gpu"}.get(platforms, platforms)
    worst: dict = {}
    log_path = os.path.join(d, f"serve{tag}.err")
    with open(log_path, "w") as log:
        client = bench_e2e.ServeClient(
            d, env=child_env(platforms, env), stderr=log)
        try:
            for eng in engines:
                for name, rep_i in plan:
                    out = f"{eng}{tag}_{name}{rep_i}.np"
                    args = (f"{analyses(d)[name]} --engine {eng} "
                            f"--ingest native -o {out}")
                    try:
                        wall, perf = client.analyze(args, timeout)
                    except (RuntimeError, TimeoutError) as exc:
                        log.flush()
                        with open(log_path) as f:
                            rep.say(f"serve stderr: {f.read()[-1500:]}")
                        raise SmokeFailure(str(exc)) from exc
                    kind = "warm" if rep_i else "cold"
                    rep.say(f"serve {eng}{tag} {name}{rep_i} ({kind}): "
                            f"wall {wall:.3f} s perf "
                            f"{json.dumps(perf, sort_keys=True)}")
                    if perf.get("ingest") != "native" \
                            or perf.get("platform") != expect_platform:
                        raise SmokeFailure(f"{out} ran with {perf}")
                    if expect_devices is not None \
                            and perf.get("devices") != expect_devices:
                        raise SmokeFailure(
                            f"{out}: mesh of {perf.get('devices')} "
                            f"devices, expected {expect_devices}")
                    compare(rep, d, out, f"exact_{name}.np",
                            f"{eng}{tag}", worst)
                    if rep_i:
                        first = os.path.join(d, f"{eng}{tag}_{name}0.np")
                        with open(first, "rb") as f0, \
                                open(os.path.join(d, out), "rb") as f1:
                            if f0.read() != f1.read():
                                raise SmokeFailure(
                                    f"warm {out} differs from cold")
        finally:
            client.close()
    rep.say(f"serve{tag} worst margins: {json.dumps(worst)}")
    return worst


# --- 6. kernels at real widths --------------------------------------------

def _tile_events(rng, tile_len: int, n: int):
    """Clustered + background fragment events (bench.py's shape)."""
    hot = rng.randint(0, tile_len - 2000, 64)
    base = np.where(rng.rand(n) < 0.7,
                    hot[rng.randint(0, 64, n)] + rng.randint(0, 1500, n),
                    rng.randint(0, tile_len - 500, n))
    start = np.clip(base, 0, tile_len - 1).astype(np.int32)
    end = np.clip(base + rng.randint(80, 400, n), 1,
                  tile_len).astype(np.int32)
    count = rng.choice([1, 1, 1, 1, 2, 4], n).astype(np.uint8)
    return start, end, count


def _close(got, want) -> float:
    """Worst |got - want| / max(1, |want|), the measure the 1e-4
    float32 tolerance applies to."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.size == 0:
        return 0.0
    return float(np.max(np.abs(got - want)
                        / np.maximum(1.0, np.abs(want))))


def kernel_phase(rep: Report, seed: int = 0, tile_len: int = 1 << 24,
                 events: int = 1 << 19, k_excl: int = 64,
                 chain_m: int = 1 << 22, chain_reps: int = 50,
                 expect_platform: str = "gpu") -> dict:
    """One real-width tile on the device vs the numpy engine, plus the
    lax-chain timing.  Returns the device JAX ran on."""
    from genrich_tpu.utils.xla_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from genrich_tpu.engine import chisq as ref_chisq
    from genrich_tpu.engine import peaks as ref_peaks
    from genrich_tpu.engine import pileup as ref_pileup
    from genrich_tpu.engine import pvalue as ref_pvalue
    from genrich_tpu.engine.jax_bridge import PEAK_CAP
    from genrich_tpu.ops.chisq_jax import fisher_combine
    from genrich_tpu.ops.peaks_jax import call_peaks
    from genrich_tpu.ops.pileup_jax import (canon_value, event_deltas,
                                            pack_deltas, unpack_deltas)
    from genrich_tpu.ops.pipeline_jax import tile_coverage, tile_stats
    from genrich_tpu.ops.pvalue_jax import calc_pval

    dev = jax.devices()[0]
    if dev.platform != expect_platform:
        raise SmokeFailure(f"phase 6 runs on {dev.platform}, expected "
                           f"{expect_platform}")
    f32 = np.float32
    rng = np.random.RandomState(seed)
    es, ee, ec = _tile_events(rng, tile_len, events)
    cs, ce, cc = _tile_events(rng, tile_len, events)
    gap = tile_len // k_excl
    xs = (np.arange(k_excl) * gap
          + rng.randint(0, gap // 2, k_excl)).astype(np.int64)
    xe = xs + rng.randint(100, gap // 4, k_excl)
    bed = [int(v) for pair in zip(xs, xe) for v in pair]
    excl = np.stack([xs, xe], 1).astype(np.int32)

    z4 = jnp.zeros(4, jnp.int32)
    tl = jnp.int32(tile_len)
    cov_fn = jax.jit(lambda a, b, c, d, e, f, x: tile_coverage(
        a, b, c, d, e, f, x, tl, z4, z4))
    stats_fn = jax.jit(tile_stats)
    ev_dev = [jnp.asarray(v) for v in (es, ee, ec, cs, ce, cc, excl)]

    def compiled(name, fn, *args, **kw):
        t0 = time.perf_counter()
        c = fn.lower(*args, **kw).compile()
        ma = c.memory_analysis()
        rep.say(f"{name}: compiled in {time.perf_counter() - t0:.1f} s, "
                f"memory_analysis {ma}")
        return c, ma

    cov_c, cov_ma = compiled("tile_coverage", cov_fn, *ev_dev)
    (starts, ends, ev, cr, excluded, live, frag,
     cfrag) = cov_c(*ev_dev)
    m_rows = starts.shape[0]
    # a [M, K] compare_all intermediate of the -E lookup would take
    # M * 2K bytes even as bool; the GPU program must not hold one
    # (XLA:CPU does materialize it, which the CPU tests tolerate)
    if expect_platform == "gpu" \
            and cov_ma.temp_size_in_bytes >= m_rows * 2 * k_excl:
        raise SmokeFailure(f"tile_coverage temp "
                           f"{cov_ma.temp_size_in_bytes} B holds an "
                           f"[M={m_rows}, K={2 * k_excl}] intermediate")

    # numpy engine: RLE pileups of both channels, factor and lambda
    ref_e, terms_e = ref_pileup.expt_pileup(es.astype(np.int64),
                                            ee.astype(np.int64),
                                            ec.astype(np.int64),
                                            tile_len, bed)
    ref_c, terms_c = ref_pileup.expt_pileup(cs.astype(np.int64),
                                            ce.astype(np.int64),
                                            cc.astype(np.int64),
                                            tile_len, bed)
    frag_ref = ref_pileup.exact_sum_f64(terms_e)
    cfrag_ref = ref_pileup.exact_sum_f64(terms_c)
    lam = ref_pileup.calc_lambda(frag_ref, tile_len)
    factor = ref_pileup.calc_factor(frag_ref, cfrag_ref)

    h = jax.device_get((starts, ends, ev, cr, excluded, live, frag,
                        cfrag))
    h_starts, h_ends, h_ev, h_cr, h_exc, h_live = h[:6]
    keep = h_live & (h_ends > h_starts)
    s_k, e_k = h_starts[keep].astype(np.int64), h_ends[keep]
    if s_k[0] != 0 or not np.array_equal(s_k[1:], e_k[:-1]) \
            or e_k[-1] != tile_len:
        raise SmokeFailure("device intervals do not tile the span")
    at = np.searchsorted(ref_e.end, s_k, side="right")
    exc_ref = ref_pileup._excluded_mask(s_k, bed)
    if not np.array_equal(exc_ref, h_exc[keep]):
        raise SmokeFailure("device -E mask differs from the reference")
    inside = ~exc_ref
    e_ref = ref_e.cov[at]
    c_ref = ref_c.cov[np.searchsorted(ref_c.end, s_k, side="right")]
    bad_e = int(np.sum(h_ev[keep][inside] != e_ref[inside]))
    bad_c = int(np.sum(h_cr[keep][inside] != c_ref[inside]))
    frag_rel = max(_close(h[6], frag_ref), _close(h[7], cfrag_ref))
    rep.say(f"coverage: {int(keep.sum())} intervals of {m_rows} rows; "
            f"expt mismatches {bad_e}, ctrl mismatches {bad_c}; "
            f"fragment sums rel err {frag_rel:.3g}")
    if bad_e or bad_c or frag_rel > 1e-4:
        raise SmokeFailure("device coverage differs from the numpy "
                           "engine")

    stats_c, _ = compiled("tile_stats", stats_fn, ev, cr, excluded,
                          jnp.float32(factor), jnp.float32(lam))
    pv = stats_c(ev, cr, excluded, jnp.float32(factor), jnp.float32(lam))
    ctrl_eff = np.where(exc_ref, f32(-1.0),
                        np.maximum(f32(factor) * c_ref, f32(lam)))
    p_ref = ref_pvalue.calc_pval(np.where(exc_ref, f32(0.0), e_ref),
                                 ctrl_eff.astype(f32))
    pv_h = np.asarray(pv)[keep]
    p_rel = _close(pv_h, p_ref)
    rep.say(f"-log10 p: worst rel err {p_rel:.3g} over "
            f"{len(p_ref)} intervals")
    if p_rel > 1e-4:
        raise SmokeFailure("device -log10 p differs from the numpy "
                           "engine")

    min_pq, min_auc = f32(2.0), f32(20.0)
    peaks_fn = jax.jit(functools.partial(
        call_peaks, min_len=0, max_gap=100,
        k_peaks=min(PEAK_CAP, m_rows)))
    neg = jnp.full_like(pv, -1.0)
    peaks_c, _ = compiled("call_peaks", peaks_fn, starts, ends, pv, pv,
                          neg, live, jnp.float32(min_pq),
                          jnp.float32(min_auc))
    pk = jax.device_get(peaks_c(starts, ends, pv, pv, neg, live,
                                jnp.float32(min_pq),
                                jnp.float32(min_auc)))
    ok = pk.valid
    want = ref_peaks.call_peaks_chrom(pv_h, pv_h, None, e_k, min_pq,
                                      min_auc, 0, 100)
    got = list(zip(pk.start[ok].tolist(), pk.end[ok].tolist(),
                   pk.summit_pos[ok].tolist()))
    if got != [(w.start, w.end, w.summit_pos) for w in want]:
        raise SmokeFailure(f"call_peaks: {len(got)} device peaks vs "
                           f"{len(want)} reference peaks differ")
    auc_rel = _close(pk.auc[ok], [w.auc for w in want])
    rep.say(f"call_peaks: {len(got)} peaks identical in position; AUC "
            f"worst rel err {auc_rel:.3g}")
    if auc_rel > 1e-4:
        raise SmokeFailure("device peak AUCs differ from the numpy "
                           "engine")

    pv_b = np.asarray(stats_c(ev, cr, excluded, jnp.float32(factor),
                              jnp.float32(lam * f32(1.5))))[keep]
    fisher_fn = jax.jit(fisher_combine)
    both = jnp.asarray(np.stack([pv_h, pv_b]))
    fisher_c, _ = compiled("fisher_combine", fisher_fn, both)
    comb = np.asarray(fisher_c(both))
    comb_ref = ref_chisq.combine_pvals(
        [ref_pileup.Pileup(e_k, pv_h), ref_pileup.Pileup(e_k, pv_b)],
        tile_len).cov
    f_rel = _close(comb, comb_ref)
    rep.say(f"fisher_combine: worst rel err {f_rel:.3g} over "
            f"{len(comb)} intervals")
    if f_rel > 1e-4:
        raise SmokeFailure("device Fisher combination differs from the "
                           "numpy engine")

    # the post-sort chain, left to XLA to fuse, at 2^22 rows
    n_ev = chain_m // 2
    cs_, ce_, cc_ = _tile_events(rng, tile_len, n_ev)
    add, sub = event_deltas(jnp.asarray(cc_))
    order = np.argsort(np.concatenate([cs_, ce_]), kind="stable")
    packed = pack_deltas(jnp.concatenate([add, sub])[order])

    def chain(packed, lam_):
        vals = canon_value(jnp.cumsum(unpack_deltas(packed), axis=0))
        return vals, calc_pval(vals, jnp.full_like(vals, lam_))

    chain_c, _ = compiled("lax chain", jax.jit(chain), packed,
                          jnp.float32(lam))
    jax.block_until_ready(chain_c(packed, jnp.float32(lam)))
    single = []
    for _ in range(chain_reps):
        t0 = time.perf_counter()
        jax.block_until_ready(chain_c(packed, jnp.float32(lam)))
        single.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    outs = [chain_c(packed, jnp.float32(lam)) for _ in range(chain_reps)]
    jax.block_until_ready(outs)
    back = (time.perf_counter() - t0) / chain_reps
    med = sorted(single)[len(single) // 2]
    moved = chain_m * (4 + 4 + 4)     # packed in, values + p out
    rep.say(f"lax chain cumsum -> canon_value -> calc_pval at m = "
            f"{chain_m}: median {1e3 * med:.4f} ms per blocked call, "
            f"{1e3 * back:.4f} ms per call back to back "
            f"({moved / back / 1e9:.1f} GB/s of 12 B/row) on "
            f"{dev.device_kind}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


# --- four cards -------------------------------------------------------------

def multi_gpu(rep: Report, d: str, n: int, platforms: str = "cuda",
              one_device_env=None) -> dict:
    """The sharded path over n devices vs a 1-device mesh (a child
    that sees only the first card) and the exact engine, then the
    collective dry run; returns the device info."""
    run_exact(rep, d, ("A", "C"))
    plan = (("A", 0), ("A", 1), ("C", 0))
    serve_phase(rep, d, engines=("sharded",), plan=plan,
                platforms=platforms, expect_devices=n, tag=f"_d{n}")
    serve_phase(rep, d, engines=("sharded",), plan=plan,
                platforms=platforms, expect_devices=1, tag="_d1",
                env=one_device_env or {"CUDA_VISIBLE_DEVICES": "0"})
    worst: dict = {}
    for name in ("A0", "C0"):
        compare(rep, d, f"sharded_d{n}_{name}.np",
                f"sharded_d1_{name}.np", f"{n}-card vs 1-card", worst)
        with open(os.path.join(d, f"sharded_d{n}_{name}.np"), "rb") as a, \
                open(os.path.join(d, f"sharded_d1_{name}.np"), "rb") as b:
            rep.say(f"{name}: {n}-card output byte-identical to 1-card: "
                    f"{a.read() == b.read()}")

    import jax
    import __graft_entry__
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        __graft_entry__.dryrun_multichip(n)
    rep.say(buf.getvalue().strip())
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=2_000_000,
                    help="read pairs per synthetic BAM (default 2M, "
                         "about 4.9M records)")
    ap.add_argument("--gpus", type=int, default=1,
                    help="run only the sharded path over this many "
                         "cards (default 1: the whole smoke run)")
    args = ap.parse_args(argv)
    os.environ["JAX_PLATFORMS"] = "cuda"

    info = device_info()
    check_device(info, args.gpus)
    rep = Report(bench_e2e.gpu_card())
    rep.say(f"device: {json.dumps(info)}")
    build_native(rep)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        make_data(rep, d, args.pairs)
        if args.gpus > 1:
            final = multi_gpu(rep, d, args.gpus)
        else:
            run_exact(rep, d, ("A", "B", "C"))
            serve_phase(rep, d)
            final = kernel_phase(rep)
    check_device(final, args.gpus)
    print(json.dumps({"ok": True, "device": final}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
