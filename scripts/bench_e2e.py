"""End-to-end benchmark: compiled reference vs our CLI on one BAM.

Synthesizes (and caches) a multi-million-record BGZF BAM with the
published workload's shape (SURVEY.md §6: ATAC, PCR duplicates,
multimappers, -r -j -q 0.05), then times

  - the compiled reference binary (tests/oracle.build_oracle),
  - ``--engine exact``  (native ingest + numpy; byte-parity checked),
  - ``--engine jax`` and ``--engine sharded`` through the persistent
    serve mode (``--serve``): one process, cold first analysis
    (includes XLA program compilation), then warm repeats that reuse
    the compiled programs.  ``warm_s`` is the steady-state number a
    resident deployment sees; ``load_s = cold_s - warm_s`` is the
    one-time cost.  The serve process is the only one that opens the
    device: the exact legs run with ``JAX_PLATFORMS=cpu``, and the
    caller must not hold the device while this runs.

Protocol: every subprocess leg runs ``reps`` times (default 3) and
reports the median plus the spread (max-min)/median; peak RSS is
captured via wait4/ru_maxrss for the reference and exact legs (the
reference holds dense 3 B/bp diff arrays — README.md:533 — ours is
O(events)).

Prints a JSON dict; bench.py embeds it in its single-line output as
the "e2e" key.  The reference's only published number is 146M records
in 10.5 min single-core (README.md:459-511, ~232K records/s); this
measures the actual ratio on the same machine instead of trusting
that anchor.
"""

from __future__ import annotations

import json
import os
import resource
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.environ.get("GENRICH_PERF_DIR", "/tmp/genrich_perf")
FLAGS = ["-r", "-j", "-q", "0.05", "-a", "20"]

# hg19-scale genome (2.75 Gbp over 3 chroms): the regime of the
# reference's sole published benchmark (README.md:459-511, 2.83 Gbp).
# Genome length is a first-class cost axis — the reference's dense
# 3 B/bp diff arrays and per-base sweeps are O(genome), our
# event-based engine O(events) — so benching on a toy genome would
# hide most of the honest difference.
HG_CHROMS = (("chr1", 1_100_000_000), ("chr2", 900_000_000),
             ("chr3", 750_000_000))


def gpu_card() -> str:
    """The card's name and power limit as nvidia-smi reports them
    (one line per card); raises if nvidia-smi cannot read a card."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    card = "; ".join(ln.strip() for ln in r.stdout.splitlines()
                     if ln.strip())
    if r.returncode != 0 or not card:
        raise RuntimeError(f"nvidia-smi read no card: "
                           f"{r.stderr.strip()[-300:]}")
    return card


def _bam_path(n_pairs: int, chroms=None) -> str:
    cache = os.environ.get("GENRICH_PERF_DIR", CACHE_DIR)
    os.makedirs(cache, exist_ok=True)
    tag = "hg" if chroms is None else "c%d" % sum(
        l for _, l in chroms)
    chroms = HG_CHROMS if chroms is None else chroms
    path = os.path.join(cache, f"atac_e2e_{tag}_{n_pairs}.bam")
    if not os.path.exists(path):
        sys.stderr.write(f"# synthesizing {n_pairs}-pair BAM...\n")
        sys.path.insert(0, os.path.join(REPO, "scripts"))
        import perf_synth
        perf_synth.synth_bam(path, n_pairs, chroms=chroms)
    return path


def _oracle_bin() -> str:
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import oracle
    return oracle.build_oracle()


def _env(extra=None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if extra:
        env.update(extra)
    return env


def _run_rss(cmd, cwd, timeout, extra_env=None):
    """One run: (wall_s, rc, stderr_text, peak_rss_mb).

    Reads stderr to EOF itself and reaps with os.wait4 for rusage
    (ru_maxrss, KiB on Linux) — Popen.communicate() would reap the
    child first and lose the rusage.  A watchdog kills on timeout.
    """
    import threading
    proc = subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True,
                            env=_env(extra_env))
    t0 = time.perf_counter()
    timed_out = []
    watchdog = threading.Timer(timeout, lambda: (
        timed_out.append(1), proc.kill()))
    watchdog.start()
    try:
        err = proc.stderr.read()
    finally:
        watchdog.cancel()
    _, status, ru = os.wait4(proc.pid, 0)
    proc.returncode = os.waitstatus_to_exitcode(status)
    if timed_out:
        return time.perf_counter() - t0, None, "timeout", 0.0
    return (time.perf_counter() - t0, proc.returncode, err,
            ru.ru_maxrss / 1024.0)


def _timed_leg(cmd, cwd, timeout, reps, extra_env=None):
    """reps runs -> dict(median_s, rep_s, spread_pct, rss_mb)."""
    times, rss = [], 0.0
    err = ""
    for _ in range(reps):
        t, rc, err, r = _run_rss(cmd, cwd, timeout, extra_env)
        assert rc == 0, (cmd[0], (err or "")[-500:])
        times.append(t)
        rss = max(rss, r)
    ts = sorted(times)
    med = ts[len(ts) // 2]
    return {"median_s": round(med, 2),
            "rep_s": [round(t, 2) for t in times],
            "spread_pct": round(100.0 * (ts[-1] - ts[0]) / med, 1),
            "rss_mb": round(rss, 1)}, err


class ServeClient:
    """Drives a ``--serve`` process: one analysis per submitted line.

    ``stderr`` (a file object) receives the server's diagnostics; a
    status other than OK raises, so a failed analysis never passes as
    a timing."""

    def __init__(self, cwd, ready_timeout=300.0, env=None,
                 stderr=subprocess.DEVNULL):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "genrich_tpu", "--serve"],
            cwd=cwd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=stderr, text=True, env=_env(env))
        line = self._read_line(ready_timeout)
        if line != "READY":
            self.close()
            raise RuntimeError(f"serve: expected READY, got {line!r}")

    def _read_line(self, timeout):
        import select
        r, _, _ = select.select([self.proc.stdout], [], [], timeout)
        if not r:
            raise TimeoutError("serve: no response")
        return self.proc.stdout.readline().strip()

    def analyze(self, args: str, timeout: float):
        """-> (wall_s, perf_dict): perf is the server's stage/link
        decomposition from the ``OK <wall> <json>`` status line."""
        t0 = time.perf_counter()
        self.proc.stdin.write(args + "\n")
        self.proc.stdin.flush()
        line = self._read_line(timeout)
        if not line.startswith("OK"):
            raise RuntimeError(f"serve: {args!r} -> {line!r}")
        parts = line.split(None, 2)
        perf = json.loads(parts[2]) if len(parts) > 2 else {}
        return time.perf_counter() - t0, perf

    def close(self):
        """Ask the server to exit; kill it if it does not."""
        try:
            self.proc.stdin.write("EXIT\n")
            self.proc.stdin.flush()
            self.proc.wait(timeout=60)
        except (OSError, subprocess.TimeoutExpired):
            self.proc.kill()
            self.proc.wait()


def verify_rows(ref_path: str, out_path: str, thresh: float,
                eps: float = 0.02, rel: float = 1e-4) -> dict:
    """Row-level device-vs-reference check (threshold-aware).

    Same rule as tests/test_engine_jax_cli.py: matched rows share
    exact (chrom, start, end) and their float columns (signal, -log10
    p, -log10 q) agree within ``rel`` relative (float32 device
    statistics, PARITY.md); an unmatched row must either overlap a
    peak of the other side (a marginal edge interval moved) or be
    threshold-marginal — its summit stat within ``eps`` of the
    significance cutoff, where float32 may legitimately flip
    significance — and at least 95% of the reference rows match.
    Returns counts, the worst margins, and ``ok``.
    """
    ref = open(ref_path).read().splitlines()
    out = open(out_path).read().splitlines()
    key = lambda ln: tuple(ln.split("\t")[:3])  # noqa: E731
    rk = {key(ln): ln for ln in ref}
    ok_ = {key(ln): ln for ln in out}

    def spans(lines):
        return [(f[0], int(f[1]), int(f[2]))
                for f in (ln.split("\t") for ln in lines)]

    def unmatched(only_keys, src, other_spans):
        worst, moved = 0.0, 0
        for k in only_keys:
            f = src[k].split("\t")
            chrom, s, e, q = f[0], int(f[1]), int(f[2]), float(f[8])
            if any(c == chrom and s < oe and os_ < e
                   for c, os_, oe in other_spans):
                moved += 1
                continue
            worst = max(worst, abs(q - thresh))
        return worst, moved

    w1, m1 = unmatched(rk.keys() - ok_.keys(), rk, spans(out))
    w2, m2 = unmatched(ok_.keys() - rk.keys(), ok_, spans(ref))
    inter = rk.keys() & ok_.keys()
    worst_rel = 0.0
    for k in inter:
        fr, fo = rk[k].split("\t"), ok_[k].split("\t")
        for i in (6, 7, 8):
            x, y = float(fr[i]), float(fo[i])
            worst_rel = max(worst_rel, abs(x - y) / max(1.0, abs(x)))
    match_frac = len(inter) / max(len(ref), 1)
    worst = max(w1, w2)
    return {"rows_ref": len(ref), "rows_out": len(out),
            "match_frac": round(match_frac, 4),
            "edge_moved": m1 + m2,
            "worst_unmatched_margin": round(worst, 4),
            "worst_float_rel": worst_rel,
            "ok": bool(worst <= eps and worst_rel <= rel
                       and match_frac >= 0.95)}


def _serve_leg(client: ServeClient, bam: str, engine: str, d: str,
               warm_reps: int, cold_timeout: float) -> dict:
    """Cold + warm timings for one device engine via the server."""
    base = f"-t {bam} --engine {engine} " + " ".join(FLAGS)
    out = {}
    cold, _ = client.analyze(f"{base} -o {engine}_cold.np",
                             cold_timeout)
    out["cold_s"] = round(cold, 2)
    warms = []
    for i in range(warm_reps):
        warms.append(client.analyze(f"{base} -o {engine}_w{i}.np",
                                    max(cold_timeout / 2, 120.0)))
    ws = sorted(w for w, _ in warms)
    warm = ws[len(ws) // 2]
    out["warm_s"] = round(warm, 2)
    out["warm_rep_s"] = [round(w, 3) for w, _ in warms]
    out["load_s"] = round(cold - warm, 2)
    # decomposition of the median warm rep: ingest vs upload bytes/s
    # vs dispatch count vs blocking fetches
    for w, perf in warms:
        if w == warm and perf:
            out["warm_decomp"] = perf
            break
    out["peaks"] = sum(1 for _ in open(
        os.path.join(d, f"{engine}_w{warm_reps - 1}.np")))
    # row-level verification of the device run against the reference
    # output: -q 0.05 -> threshold -log10(0.05)
    ref_np = os.path.join(d, "ref.np")
    if os.path.exists(ref_np):
        out["rows"] = verify_rows(
            ref_np, os.path.join(d, f"{engine}_w{warm_reps - 1}.np"),
            thresh=1.3010299956639813)
    return out


def bench_e2e(n_pairs: int = 2_000_000, include_jax: bool = True,
              timeout: float = 1800.0, chroms=None,
              reps: int = None) -> dict:
    reps = reps or int(os.environ.get("GENRICH_BENCH_E2E_REPS", "3"))
    bam = _bam_path(n_pairs, chroms)
    ref = _oracle_bin()
    genome = sum(l for _, l in (chroms or HG_CHROMS))
    out = {"n_pairs": n_pairs, "genome_bp": genome,
           "flags": " ".join(FLAGS), "reps": reps,
           "host": {"cpus": os.cpu_count(),
                    "loadavg": [round(x, 2)
                                for x in os.getloadavg()]}}
    # warm the page cache so the first timed rep doesn't also pay the
    # cold read of a multi-hundred-MB BAM (every later rep of every
    # contender would see it cached — same treatment for all)
    with open(bam, "rb") as f:
        while f.read(1 << 24):
            pass
    with tempfile.TemporaryDirectory() as d:
        # PAIRED protocol: a burstable box's CPU
        # throttling swings absolute walls by 2-3x between runs, so
        # ref and exact alternate rep-by-rep — each pair shares one
        # machine state — and the headline ratio is the median of the
        # per-pair ratios, with the ratio spread recorded.  -v's
        # counter block is a handful of stderr lines; its timing cost
        # is noise and it carries the record count.
        ref_cmd = [ref, "-t", bam, "-o", "ref.np", "-v"] + FLAGS
        # the exact engine never opens the device
        exact_cmd = [sys.executable, "-m", "genrich_tpu", "-t", bam,
                     "-o", "exact.np", "--engine", "exact", "-v"] \
            + FLAGS
        exact_env = {"JAX_PLATFORMS": "cpu"}
        ref_t, ref_rss = [], 0.0
        ex_t, ex_rss = [], 0.0
        ratios = []
        err = ""
        for _ in range(reps):
            t_r, rc, err, r = _run_rss(ref_cmd, d, timeout)
            assert rc == 0, ("ref", (err or "")[-500:])
            ref_t.append(t_r)
            ref_rss = max(ref_rss, r)
            t_e, rc2, err2, r2 = _run_rss(exact_cmd, d, timeout,
                                          exact_env)
            assert rc2 == 0, ("exact", (err2 or "")[-500:])
            ex_t.append(t_e)
            ex_rss = max(ex_rss, r2)
            ratios.append(t_r / t_e)

        def _leg(ts, rss):
            s = sorted(ts)
            m = s[len(s) // 2]
            return {"median_s": round(m, 2),
                    "rep_s": [round(t, 2) for t in ts],
                    "spread_pct": round(
                        100.0 * (s[-1] - s[0]) / m, 1),
                    "rss_mb": round(rss, 1)}

        out["ref"] = _leg(ref_t, ref_rss)
        out["ref_s"] = out["ref"]["median_s"]
        out["exact"] = _leg(ex_t, ex_rss)
        out["exact_s"] = out["exact"]["median_s"]
        rs = sorted(ratios)
        rmed = rs[len(rs) // 2]
        out["paired"] = {
            "ratio_rep": [round(x, 2) for x in ratios],
            "ratio_median": round(rmed, 3),
            "ratio_spread_pct": round(
                100.0 * (rs[-1] - rs[0]) / rmed, 1)}
        for line in err.splitlines():
            if "records analyzed" in line:
                out["records"] = int(line.split()[-1])
        ref_np = open(os.path.join(d, "ref.np"), "rb").read()
        out["exact_match"] = \
            ref_np == open(os.path.join(d, "exact.np"), "rb").read()
        out["exact_speedup"] = out["paired"]["ratio_median"]
        out["ref_peaks"] = len(ref_np.decode().splitlines())

        # span-parallel parser leg: the walker/
        # worker split engages by default only on >=4-core machines;
        # force 2 workers here and record the honest delta, win or
        # lose, against the paired exact median on this box.
        par_t = []
        for _ in range(max(2, reps - 1)):
            t_p, rc3, err3, _ = _run_rss(
                exact_cmd, d, timeout,
                dict(exact_env, GENRICH_INGEST_THREADS="2"))
            assert rc3 == 0, ("exact-par", (err3 or "")[-500:])
            par_t.append(t_p)
        ps = sorted(par_t)
        out["exact_par2"] = {
            "median_s": round(ps[len(ps) // 2], 2),
            "rep_s": [round(t, 2) for t in par_t],
            "delta_vs_exact_s": round(
                ps[len(ps) // 2] - out["exact_s"], 2)}

        if include_jax:
            # device engines through the persistent serve process:
            # cold (program compile) vs warm (steady state); a failed
            # or timed-out analysis raises and fails the bench
            client = ServeClient(d)
            try:
                for eng in ("jax", "sharded"):
                    res = _serve_leg(client, bam, eng, d, warm_reps=3,
                                     cold_timeout=timeout)
                    out[eng] = res
                    out[f"{eng}_s"] = res["warm_s"]
                    out[f"{eng}_speedup"] = round(
                        out["ref_s"] / res["warm_s"], 3)
            finally:
                client.close()
    if "records" in out:
        out["exact_records_per_s"] = round(
            out["records"] / out["exact_s"], 1)
        out["ref_records_per_s"] = round(
            out["records"] / out["ref_s"], 1)
    return out


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2_000_000
    jax_flag = os.environ.get("GENRICH_BENCH_E2E_JAX", "1") != "0"
    print(json.dumps(bench_e2e(n, include_jax=jax_flag), indent=2))
