"""Virtual-mesh scaling measurement for the sharded pipeline.

This script measures no multi-device speedup: that needs several
cards (``python chip_smoke.py --gpus 4`` runs the sharded path on
four).  What CAN be measured honestly on the virtual CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8, all devices
sharing the same physical cores) is the *overhead* the sharded
decomposition adds on top of the identical computation:

  - fixed total work: T tiles of E events (+ ctrl, exclusions,
    q-values on, boundary-straddling peaks);
  - leg D=k: the full sharded pipeline (shard_map + psum/all_gather
    collectives + host boundary merge) over a k-device mesh,
    T/k tiles per device;
  - every leg runs the same FLOPs on the same physical cores, so
    wall(D=1) / wall(D=k) isolates the collective + partitioning
    cost — an upper bound on what the mesh program would lose to
    collectives on real ICI (where per-hop latency is far below a
    CPU thread switch).

Emits JSON: {"t_ms_by_D": {...}, "overhead_pct_by_D": {...},
"efficiency_pct_by_D": {...}} — efficiency here = t(1)/t(k), the
fraction of the single-device-program step time the sharded program
achieves with all collectives enabled.

Run: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python scripts/bench_scaling.py
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# This measurement needs the virtual 8-device CPU mesh, and XLA reads
# its flags once at backend start — re-exec once with the full
# required environment.
if os.environ.get("GENRICH_SCALING_CHILD") != "1":
    env = dict(os.environ)
    env.update({"GENRICH_SCALING_CHILD": "1",
                "JAX_PLATFORMS": "cpu",
                "XLA_FLAGS": (env.get("XLA_FLAGS", "") +
                              " --xla_force_host_platform_device_"
                              "count=8").strip()})
    os.execve(sys.executable,
              [sys.executable, os.path.abspath(__file__)]
              + sys.argv[1:], env)


def build_fixture(tiles: int, tile_len: int, events_per_tile: int):
    import numpy as np
    from genrich_tpu.parallel import mesh as pmesh

    genome = tiles * tile_len
    rng = np.random.RandomState(7)
    n = tiles * events_per_tile

    def events(n_bg, clusters):
        s = [rng.randint(0, genome - 256, n_bg)]
        for (lo, hi, k) in clusters:
            s.append(rng.randint(lo, hi, k))
        s = np.concatenate(s).astype(np.int64)
        e = np.minimum(s + rng.randint(40, 200, len(s)), genome)
        return s, e, np.ones(len(s), np.int32)

    b = (tiles - 1) * tile_len
    es, ee, ec = events(n, [(tile_len // 2, tile_len // 2 + 400,
                             n // 8), (b - 300, b + 300, n // 8)])
    cs, ce, cc = events(n, [])
    t_s, t_e, t_c = pmesh.split_events_to_tiles(es, ee, ec, tiles,
                                                tile_len)
    c_s, c_e, c_c = pmesh.split_events_to_tiles(cs, ce, cc, tiles,
                                                tile_len)
    # pad widths equal so every D reuses one sort shape
    w = 1
    while w < max(t_s.shape[1], c_s.shape[1]):
        w <<= 1
    pad = lambda a, v: np.pad(a, ((0, 0), (0, w - a.shape[1])),
                              constant_values=v)  # noqa: E731
    t_s, t_e = pad(t_s, tile_len), pad(t_e, tile_len)
    t_c = pad(t_c, 0)
    c_s, c_e = pad(c_s, tile_len), pad(c_e, tile_len)
    c_c = pad(c_c, 0)
    excl = np.full((tiles, 1, 2), tile_len, np.int32)
    excl[0, 0] = (100, 300)
    return (t_s, t_e, t_c, c_s, c_e, c_c, excl, tile_len, genome)


def time_leg(n_devices: int, fixture, reps: int = 9):
    import jax
    import numpy as np
    from genrich_tpu.parallel import mesh as pmesh

    (t_s, t_e, t_c, c_s, c_e, c_c, excl, tile_len, genome) = fixture
    mesh = pmesh.make_mesh(n_devices)
    import jax.numpy as jnp
    args = tuple(jnp.asarray(x) for x in
                 (t_s, t_e, t_c, c_s, c_e, c_c, excl))
    kern = pmesh.ShardedKernels(mesh, tile_len)

    def step():
        res, lam, factor = pmesh.sharded_analyze_full(
            mesh, *args, tile_len=tile_len, genome_len=genome,
            min_pq=1.0, min_auc=2.0, min_len=0, max_gap=100,
            qval_opt=True, kern=kern)
        merged = pmesh.merge_tile_peaks(res, tile_len, 2.0, 0, 100)
        return merged, lam

    merged, lam = step()          # compile + warm
    assert merged, "fixture must produce peaks"
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        m, _ = step()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], merged


def _pin_one_core() -> None:
    """Confine every thread of this process to a single CPU so every
    leg runs the same fixed work on the same one core.

    Round 3's numbers were confounded: XLA:CPU gives each virtual
    device its own thread, so the D>=4 legs exploited the box's
    second core while the D=1 program could not — "efficiencies" over
    100%.  With the whole process pinned to one core no leg can win
    by threading, and t(1)/t(D) isolates exactly the shard_map
    partitioning + collective overhead.

    Must run AFTER the jax backend exists: XLA caps the forced
    host-platform device count at the visible cores, so pinning
    before init would collapse the 8-device mesh to 1.  ``taskset
    -a`` retargets the already-spawned XLA threads; threads created
    later inherit the pinned mask.
    """
    import subprocess
    r = subprocess.run(["taskset", "-a", "-p", "1", str(os.getpid())],
                       capture_output=True)
    if r.returncode != 0:
        try:                     # fallback: at least the main thread
            os.sched_setaffinity(0, {0})
        except (AttributeError, OSError) as exc:
            sys.stderr.write(f"# warning: could not pin: {exc}\n")


def main() -> None:
    import jax
    devs = jax.devices()
    _pin_one_core()
    tiles = 8
    assert len(devs) >= tiles, (
        f"need >= {tiles} devices (set JAX_PLATFORMS=cpu and "
        f"XLA_FLAGS=--xla_force_host_platform_device_count={tiles})")
    fixture = build_fixture(tiles, 1 << 16, 1 << 12)
    out = {"tiles": tiles, "tile_len": 1 << 16,
           "events_per_tile": 1 << 12, "t_ms_by_D": {},
           "overhead_pct_by_D": {}, "efficiency_pct_by_D": {},
           "note": ("virtual CPU mesh pinned to ONE core: every leg "
                    "runs identical total work with no threading "
                    "headroom, so t(1)/t(D) is purely the shard_map "
                    "partitioning + collective overhead (an upper "
                    "bound on the loss real ICI collectives would "
                    "add); it is NOT a multi-chip speedup claim")}
    base = None
    peaks0 = None
    for d in (1, 2, 4, 8):
        t, merged = time_leg(d, fixture)
        if peaks0 is None:
            peaks0 = merged
        else:
            assert merged == peaks0, f"D={d} peaks differ"
        out["t_ms_by_D"][str(d)] = round(1e3 * t, 2)
        if base is None:
            base = t
        out["overhead_pct_by_D"][str(d)] = round(
            100.0 * (t - base) / base, 1)
        out["efficiency_pct_by_D"][str(d)] = round(
            100.0 * base / t, 1)
    out["peaks"] = len(peaks0)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
