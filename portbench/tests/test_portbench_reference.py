"""The plain reference against direct sums and scipy's peak finder."""

import numpy as np
import pytest
import torch

from portbench.reference import xcorr_peaks as ref

signal = pytest.importorskip("scipy.signal")


def test_portbench_the_reference_correlates_by_the_sum():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(300).astype(np.float32)
    s = rng.standard_normal(37).astype(np.float32)
    wins, lens = ref.windows(torch.from_numpy(x), 100, 139)
    got = ref.correlate(wins, torch.from_numpy(s)).numpy()
    for k in range(wins.shape[0]):
        w = x[100 * k : 100 * k + 139]
        want = np.correlate(w.astype(np.float64), s.astype(np.float64),
                            "valid") / np.sum(s.astype(np.float64) ** 2)
        np.testing.assert_allclose(got[k, : len(want)], want, atol=2e-6)


@pytest.mark.parametrize("distance", [1, 7, 50])
def test_portbench_the_reference_picks_as_scipy(distance):
    rng = np.random.default_rng(distance)
    x = rng.standard_normal((3, 400)).astype(np.float32)
    valid = torch.tensor([400, 333, 250])
    picks = ref.pick(torch.from_numpy(x), valid, distance, 1000)
    for r in range(3):
        row = x[r, : int(valid[r])].astype(np.float64)
        idx, _ = signal.find_peaks(row, distance=distance)
        prom = signal.peak_prominences(row, idx)[0]
        got = sorted((lag, pr) for rr, lag, _, pr in picks if rr == r)
        assert [g[0] for g in got] == list(idx)
        np.testing.assert_allclose([g[1] for g in got], prom, atol=1e-6)


def test_portbench_the_reference_dedups_as_the_upstream_matcher():
    sr = 10
    peaks = [(100, 0.9, 0.5), (100, 0.9, 0.6), (140, 0.8, 0.7),
             (400, 0.5, 0.3)]
    # 100 (the more prominent of the seam pair) is overshadowed by 140
    # within 8 s; 400 stands alone
    assert ref.overshadow(peaks, sr, 8.0) == [(140, 0.8, 0.7),
                                              (400, 0.5, 0.3)]
