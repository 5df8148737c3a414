"""The end-to-end bench harness itself (scripts/bench_e2e.py).

Runs the reference-vs-exact comparison at toy scale so the harness
behind bench.py's "e2e" key can't rot: synth ->
reference -> --engine exact -> byte-parity, all through the real
harness code path (jax leg excluded; it needs the device).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "scripts"))


def test_bench_e2e_exact_leg(tmp_path, monkeypatch):
    monkeypatch.setenv("GENRICH_PERF_DIR", str(tmp_path))
    import bench_e2e
    chroms = (("chr1", 40_000_000), ("chr2", 25_000_000))
    out = bench_e2e.bench_e2e(20_000, include_jax=False, timeout=300,
                              chroms=chroms)
    assert out["exact_match"] is True
    assert out["records"] > 40_000
    assert out["ref_s"] > 0 and out["exact_s"] > 0
    assert (tmp_path / "atac_e2e_c65000000_20000.bam").exists()


def test_bench_compact_headline_contract():
    """bench.py's last stdout line must survive a ~2 KB tail capture
    (an oversized line loses the headline) and carry the headline
    metric and the card it was measured on."""
    import json
    import bench

    out = {
        "metric": "genome_positions_per_sec",
        "card": "NVIDIA H100 80GB HBM3, 700.00 W",
        "value": 2.92e9, "unit": "positions/s", "vs_baseline": 648.2,
        "kernel": {"roofline": {"frac_vs_ideal_sort": 1.01}},
        "kernel_production": {"positions_per_sec": 6.1e7,
                              "vs_baseline": 13.4,
                              "roofline": {"frac_vs_ideal_sort": 0.9}},
        "e2e": {"paired": {"ratio_median": 22.8,
                           "ratio_spread_pct": 14.5},
                "jax_s": 4.14, "sharded_s": 6.36,
                "anything_huge": "x" * 100000},
    }
    line = json.dumps(bench.compact_headline(out))
    assert len(line) < 1500, len(line)
    parsed = json.loads(line)
    assert parsed["metric"] == "genome_positions_per_sec"
    assert parsed["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert parsed["value"] == 2.92e9
    assert parsed["vs_baseline"] == 648.2
    assert parsed["e2e_exact_ratio"] == 22.8
    # e2e leg failed entirely -> headline still prints
    out["e2e"] = {"error": "boom"}
    line2 = json.dumps(bench.compact_headline(out))
    assert json.loads(line2)["e2e_exact_ratio"] is None
