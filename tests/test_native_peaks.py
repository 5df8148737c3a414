"""Native gi_call_peaks vs the Python reference loop, randomized."""

from __future__ import annotations

import numpy as np
import pytest

from genrich_tpu.engine import peaks as peaks_mod
from genrich_tpu.ingest import native as native_mod

F32 = np.float32


@pytest.mark.usefixtures("native_lib")
@pytest.mark.parametrize("seed", range(8))
def test_native_matches_python_caller(seed, monkeypatch):
    rng = np.random.RandomState(seed)
    n = rng.randint(1, 400)
    lens = rng.randint(1, 50, n).astype(np.int64)
    ends = np.cumsum(lens)
    # stats with runs, SKIPs, exact threshold hits
    stat = rng.choice(
        [F32(-1.0), F32(0.0), F32(1.3), F32(2.0), F32(2.5), F32(7.0)],
        n).astype(F32)
    pval = (stat + rng.choice([0, 0.25], n)).astype(F32)
    qval = (stat * F32(0.5)).astype(F32) if seed % 2 else None
    min_pq = F32(2.0)
    min_auc = F32(rng.choice([0.0, 5.0, 20.0]))
    min_len = int(rng.choice([0, 10]))
    max_gap = int(rng.choice([0, 5, 100]))

    got = peaks_mod.call_peaks_chrom(stat, pval, qval, ends, min_pq,
                                     min_auc, min_len, max_gap)
    monkeypatch.setattr(native_mod, "call_peaks_native",
                        lambda *a, **k: None)
    want = peaks_mod.call_peaks_chrom(stat, pval, qval, ends, min_pq,
                                      min_auc, min_len, max_gap)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.start, g.end, g.summit_pos) \
            == (w.start, w.end, w.summit_pos)
        assert g.auc == w.auc
        assert g.summit_pval == w.summit_pval
        assert g.summit_qval == w.summit_qval
