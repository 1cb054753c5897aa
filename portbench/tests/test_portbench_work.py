"""The correlation's work against a count by hand."""

import pytest

from portbench import work


def test_portbench_work_counts_by_hand():
    # 4 Hz, chunk 2 s (8 samples), queries of 1 and 1.25 s rounded to 4
    # and 5 samples: window 8 + 5 + 2 = 15, fft_len ≥ 15 + 5 - 1 → 32
    cfg = {"sample_rate": 4, "match": {"chunk_secs": 2.0,
                                       "distance_secs": 2.0,
                                       "max_peaks_per_chunk": 64}}
    lengths = [4, 5]
    assert work.fft_len(cfg, lengths) == 32
    # a real transform of 32: 2.5 · 32 · log2 32 = 400 operations; a
    # window: one forward, and a query: 6 · 17 bins + one inverse
    per_window = 400 + 2 * (6 * 17 + 400)
    assert per_window == 1404
    # valid lags ≤ 15 - 4 + 1 = 12; distance 8 samples: 12 // 8 + 2 slots
    assert work.slots(cfg, lengths) == 3
    # episodes of 20 and 8 samples: 3 windows and 1
    F, B = work.scan_work(cfg, lengths, [20, 8], wire_bytes=2)
    assert F == 4 * per_window
    assert B == (20 + 8) * 2 + 4 * 2 * 3 * 12 + 2 * 17 * 8
    t = work.least_seconds(F, B)
    assert t == pytest.approx(max(F / 67e12, B / 3.35e12))
