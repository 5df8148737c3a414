"""Benchmark: genome-scan throughput of the device numeric pipeline.

Replicates the scale of the reference's sole published benchmark
(README.md:459-511: hg19, 2.83 Gbp scanned in 10.5 min single-core,
about 4.5M genome positions/s) on the numeric phase: fragment events ->
pileup -> log-normal p-values -> peak calling, as the fused device
kernel, over a human-sized genome.

Tiles are batched per dispatch with ``vmap`` (the same shape the mesh
path runs); each dispatch returns one scalar, results are fetched as a
list (no cross-dispatch ops), the scan is repeated and the median
reported with its spread, and a single-tile-dispatch leg separates
dispatch cost from device compute.

It measures on an NVIDIA GPU and nowhere else: JAX is held to CUDA
(``JAX_PLATFORMS=cuda`` unless set), a platform other than ``gpu``
fails the run, and the card's name and power limit go into the output.
The end-to-end leg (scripts/bench_e2e.py) runs first, while this
process has not opened the card, because its ``--serve`` child must be
the only process on it.  That leg compiles the reference binary
(tests/oracle.py); where the reference sources are absent, set
``GENRICH_BENCH_E2E=0`` to skip it.  Any leg that fails fails the run.

Output contract: the LAST stdout line is a compact JSON headline —
genome positions/s (median), vs_baseline over the reference's implied
4.5e6 positions/s, the production-shape kernel number, roofline
fractions, and the end-to-end paired ratio.  The full measurement
dict is written to BENCH_DETAIL.json next to this file (gitignored).
GENRICH_BENCH_E2E_PAIRS sizes the e2e leg (default 2M pairs ~ 4.9M
records).
"""

from __future__ import annotations

import os
import json
import sys
import time

import numpy as np

GENOME_LEN = 2_826_865_605          # reference example (README.md:490)
BASELINE_POS_PER_SEC = 4.5e6        # derived: README.md:490,496
TILE_LEN = 1 << 24                  # 16.8 Mbp tiles
EVENTS_PER_TILE = 1 << 19           # ~88M fragments genome-wide
BATCH = 48                          # tiles per dispatch (vmap axis)
BATCH_PROD = 8                      # production shape: 8-channel sort
REPS = 7                            # full-genome scans (median)


def _measure_hbm_bw(jax, jnp) -> float:
    """Achieved HBM bandwidth (bytes/s) of a trivially fusable op.

    One read + one write of a 64 MiB f32 array, best of 5.  This is
    the roofline denominator — measured on this card, not a spec
    sheet.
    """
    iters = 64
    x = jnp.ones(1 << 24, jnp.float32)
    c = jnp.float32(1.0000001)

    @jax.jit
    def f(a):
        # fori_loop: 64 full read+write passes inside ONE program, so
        # the dispatch cost amortizes away
        return jax.lax.fori_loop(0, iters, lambda i, y: y * c, a)

    jax.block_until_ready(f(x))
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(f(x))
        best = min(best, time.perf_counter() - t0)
    return iters * 2.0 * x.nbytes / best


def _roofline(bw: float, n_rows: int, sort_payload_sum_b: int,
              chain_bytes_per_row: int, t_tile_s: float) -> dict:
    """Speed-of-light model for one tile of the fused kernel.

    The super-linear steps are the ``lax.sort`` calls (the event
    sort plus call_peaks' two lexicographic sorts, all over the same
    M rows; ``sort_payload_sum_b`` is their summed per-row operand
    width).  An ideal memory-bound merge sort reads and writes every
    row log2(M) times.  Everything else is an elementwise/scan chain
    whose traffic is a few bytes per row per pass.  Reports the
    modeled time at the measured bandwidth and the achieved fraction
    (t_model / t_measured).
    """
    import math
    logm = math.ceil(math.log2(n_rows))
    b_ideal = (2.0 * n_rows * sort_payload_sum_b * logm
               + float(n_rows) * chain_bytes_per_row)
    return {
        "hbm_bw_gbps": round(bw / 1e9, 1),
        "model": {"rows": n_rows,
                  "sort_payload_sum_b": sort_payload_sum_b,
                  "merge_passes": logm,
                  "chain_bytes_per_row": chain_bytes_per_row},
        "bytes_ideal_sort_mb": round(b_ideal / 1e6, 1),
        "t_model_ideal_ms": round(1e3 * b_ideal / bw, 3),
        "t_measured_ms": round(1e3 * t_tile_s, 3),
        "frac_vs_ideal_sort": round(b_ideal / bw / t_tile_s, 3),
    }


def _tile_events(rng, n_variants=4):
    """Distinct per-tile event sets (clustered + background)."""
    variants = []
    for _ in range(n_variants):
        hot = rng.randint(0, TILE_LEN - 2000, 64)
        which = rng.randint(0, 64, EVENTS_PER_TILE)
        is_hot = rng.rand(EVENTS_PER_TILE) < 0.7
        base = np.where(is_hot,
                        hot[which] + rng.randint(0, 1500,
                                                 EVENTS_PER_TILE),
                        rng.randint(0, TILE_LEN - 500,
                                    EVENTS_PER_TILE))
        frag = rng.randint(80, 400, EVENTS_PER_TILE)
        start = np.clip(base, 0, TILE_LEN - 1).astype(np.int32)
        end = np.clip(base + frag, 1, TILE_LEN).astype(np.int32)
        count = rng.choice([1, 1, 1, 1, 2, 4], EVENTS_PER_TILE) \
            .astype(np.int32)
        variants.append((start, end, count))
    return variants


def compact_headline(out: dict) -> dict:
    """The machine-parseable last-line JSON.

    Must stay well under a ~2 KB stdout tail capture (a full dict
    would outgrow it); tests/test_bench_e2e.py pins the size
    contract."""
    e2e = out.get("e2e", {})
    paired = e2e.get("paired", {}) if isinstance(e2e, dict) else {}
    return {
        "metric": out["metric"],
        "card": out["card"],
        "value": out["value"],
        "unit": out["unit"],
        "vs_baseline": out["vs_baseline"],
        "prod_pos_per_sec":
            out["kernel_production"]["positions_per_sec"],
        "prod_vs_baseline": out["kernel_production"]["vs_baseline"],
        "roofline_frac_ideal":
            out["kernel"]["roofline"]["frac_vs_ideal_sort"],
        "roofline_frac_ideal_prod":
            out["kernel_production"]["roofline"]["frac_vs_ideal_sort"],
        "e2e_exact_ratio": paired.get("ratio_median"),
        "e2e_ratio_spread_pct": paired.get("ratio_spread_pct"),
        "e2e_jax_warm_s": e2e.get("jax_s")
            if isinstance(e2e, dict) else None,
        "e2e_sharded_warm_s": e2e.get("sharded_s")
            if isinstance(e2e, dict) else None,
        "detail": "BENCH_DETAIL.json",
    }


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import bench_e2e
    card = bench_e2e.gpu_card()
    e2e = None
    if os.environ.get("GENRICH_BENCH_E2E", "1") != "0":
        n_pairs = int(os.environ.get("GENRICH_BENCH_E2E_PAIRS",
                                     "2000000"))
        e2e = bench_e2e.bench_e2e(n_pairs, include_jax=True,
                                  timeout=1800.0)

    from genrich_tpu.utils.xla_cache import enable_compile_cache
    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    from genrich_tpu.ops.pipeline_jax import analyze_tile, \
        analyze_tile_core

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures on a GPU; JAX found "
                         f"{dev.platform}")

    n_dispatch = -(-GENOME_LEN // (TILE_LEN * BATCH))
    scanned_bp = n_dispatch * BATCH * TILE_LEN   # >= GENOME_LEN

    rng = np.random.RandomState(0)
    variants = _tile_events(rng)
    lam = np.float32(EVENTS_PER_TILE * 200.0 / TILE_LEN)

    # upload the 4 distinct variants once (a few MB); the [BATCH, E]
    # batch is built ON DEVICE by one jitted tile-op
    vs = jnp.asarray(np.stack([v[0] for v in variants]))
    ve = jnp.asarray(np.stack([v[1] for v in variants]))
    vc = jnp.asarray(np.stack([v[2] for v in variants]))

    @jax.jit
    def expand(v4):
        return jnp.tile(v4, (BATCH // v4.shape[0], 1))

    bs, be, bc = expand(vs), expand(ve), expand(vc)

    from functools import partial

    @partial(jax.jit, static_argnames=("min_len", "max_gap"))
    def step_batch(s, e, c, lam_, min_len, max_gap):
        res = jax.vmap(
            lambda a, b, d: analyze_tile_core(
                a, b, d, jnp.int32(TILE_LEN),
                jnp.zeros((4,), jnp.int32), lam_, jnp.float32(2.0),
                jnp.float32(20.0), min_len, max_gap))(s, e, c)
        return jnp.sum(res.frag_len)

    args = (bs, be, bc, jnp.float32(lam))

    # warmup / compile both programs
    jax.block_until_ready(step_batch(*args, min_len=0, max_gap=100))
    sv = [jnp.asarray(v) for v in variants[0]]
    jax.block_until_ready(analyze_tile(
        sv[0], sv[1], sv[2], jnp.int32(TILE_LEN), jnp.float32(lam),
        jnp.float32(2.0), jnp.float32(20.0), 0, 100))

    # batched full-genome scans: per-dispatch scalars collected in a
    # Python list — no cross-dispatch device ops — and fetched, which
    # forces completion; equal values across reps show the
    # executions were real
    rep_s = []
    v0 = None
    for _ in range(REPS):
        t0 = time.perf_counter()
        outs = [step_batch(*args, min_len=0, max_gap=100)
                for _i in range(n_dispatch)]
        vals = [float(o) for o in outs]
        rep_s.append(time.perf_counter() - t0)
        if v0 is None:
            v0 = vals[0]
        assert all(v == v0 for v in vals), "non-deterministic scan"
    rep_s.sort()
    med = rep_s[len(rep_s) // 2]
    spread_pct = 100.0 * (rep_s[-1] - rep_s[0]) / med

    # single-tile-dispatch leg: same tiles, one dispatch each
    n_single = 16
    t0 = time.perf_counter()
    outs = [analyze_tile(sv[0], sv[1], sv[2], jnp.int32(TILE_LEN),
                         jnp.float32(lam), jnp.float32(2.0),
                         jnp.float32(20.0), 0, 100).frag_len
            for _ in range(n_single)]
    _ = [float(o) for o in outs]
    single_s = time.perf_counter() - t0

    # --- production kernel shape ------------------------------------
    # The serve/mesh product runs tile_coverage (8-channel merged
    # expt+ctrl sort with exclusion breakpoints) + tile_stats +
    # call_peaks, a heavier program than analyze_tile_core's
    # constant-lambda path; time it so the headline has a
    # production-shape companion.
    from genrich_tpu.ops.pipeline_jax import analyze_tile_ctrl
    K_EXCL = 64
    excl_pad = jnp.full((K_EXCL, 2), TILE_LEN, jnp.int32)
    zero4 = jnp.zeros((4,), jnp.int32)

    @partial(jax.jit, static_argnames=("min_len", "max_gap"))
    def step_batch_prod(s, e, c, cs, ce, cc, lam_, min_len, max_gap):
        def one(a, b, d, xa, xb, xd):
            res, ctrl_frag, _pv, _st, _en, _lv = analyze_tile_ctrl(
                a, b, d, xa, xb, xd, excl_pad, jnp.int32(TILE_LEN),
                zero4, zero4, lam_, jnp.float32(1.0),
                jnp.float32(2.0), jnp.float32(20.0), min_len, max_gap)
            return res.frag_len + ctrl_frag
        return jnp.sum(jax.vmap(one)(s, e, c, cs, ce, cc))

    bsp = bs[:BATCH_PROD]
    bep = be[:BATCH_PROD]
    bcp = bc[:BATCH_PROD]
    # ctrl channel: the same event tensors (a control sample of equal
    # depth — the heaviest realistic sort load)
    prod_args = (bsp, bep, bcp, bsp, bep, bcp, jnp.float32(lam))
    jax.block_until_ready(step_batch_prod(*prod_args, min_len=0,
                                          max_gap=100))
    n_disp_prod = max(4, 64 // BATCH_PROD)
    prod_reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        outs = [step_batch_prod(*prod_args, min_len=0, max_gap=100)
                for _i in range(n_disp_prod)]
        _ = [float(o) for o in outs]
        prod_reps.append(time.perf_counter() - t0)
    prod_reps.sort()
    prod_med = prod_reps[len(prod_reps) // 2]
    per_tile_prod_ms = 1e3 * prod_med / (n_disp_prod * BATCH_PROD)

    # --- speed-of-light rooflines ------------------------------------
    bw = _measure_hbm_bw(jax, jnp)
    per_tile_batched_ms = 1e3 * med / (n_dispatch * BATCH)
    # light shape: M = 2E+1 breakpoints; sorts = event sort (4B key +
    # 4B packed payload) + call_peaks' two lex sorts (~20B and ~16B
    # operands); chain ~64B/row (packed read, cumsum write [M,4] i32,
    # canonicalize+pval fused, three peak cumsums, top_k)
    m_light = 2 * EVENTS_PER_TILE + 1
    roof_light = _roofline(bw, m_light, 8 + 20 + 16, 64,
                           per_tile_batched_ms / 1e3)
    # production shape: expt+ctrl points + exclusion breakpoints; the
    # 8-channel cumsum doubles the scan traffic (~96B/row)
    m_prod = 4 * EVENTS_PER_TILE + 2 * K_EXCL + 1
    roof_prod = _roofline(bw, m_prod, 8 + 20 + 16, 96,
                          per_tile_prod_ms / 1e3)

    per_tile_single_ms = 1e3 * single_s / n_single
    value = scanned_bp / med
    out = {
        "metric": "genome_positions_per_sec",
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "value": round(value, 1),
        "unit": "positions/s",
        "vs_baseline": round(value / BASELINE_POS_PER_SEC, 3),
        "kernel": {
            "tiles": n_dispatch * BATCH,
            "batch": BATCH,
            "events_per_tile": EVENTS_PER_TILE,
            "rep_s": [round(x, 4) for x in rep_s],
            "median_s": round(med, 4),
            "spread_pct": round(spread_pct, 1),
            "per_tile_ms_batched": round(per_tile_batched_ms, 4),
            "per_tile_ms_single_dispatch": round(per_tile_single_ms,
                                                 4),
            "dispatch_overhead_ms": round(
                per_tile_single_ms - per_tile_batched_ms, 4),
            "roofline": roof_light,
        },
        "kernel_production": {
            "tiles_per_dispatch": BATCH_PROD,
            "events_per_tile_per_channel": EVENTS_PER_TILE,
            "rep_s": [round(x, 4) for x in prod_reps],
            "per_tile_ms": round(per_tile_prod_ms, 4),
            "positions_per_sec": round(
                TILE_LEN / (per_tile_prod_ms / 1e3), 1),
            "vs_baseline": round(
                TILE_LEN / (per_tile_prod_ms / 1e3)
                / BASELINE_POS_PER_SEC, 3),
            "roofline": roof_prod,
        },
    }
    if e2e is not None:
        out["e2e"] = e2e

    detail_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "BENCH_DETAIL.json")
    with open(detail_path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    compact = compact_headline(out)
    print(f"# [{card}] {n_dispatch}x{BATCH} tiles x "
          f"{EVENTS_PER_TILE} events, median {med:.2f}s over {REPS} "
          f"reps (spread {spread_pct:.0f}%), device={dev.device_kind}",
          file=sys.stderr)
    print(json.dumps(compact))


if __name__ == "__main__":
    main()
