"""Every ``fft_impl`` × ``peaks_impl`` of the batch scanner against the
JAX package's, on the CPU.

The eight pairs scan the same two staged episodes at Q = 3 (odd: the pad
query of the query-pair paths runs) and Q = 1 (the single-query
branches) through ``ShardedScanner`` in both packages (JAX: a one-device
mesh, Pallas in interpret mode; the port: every kernel's plain version),
on the mulaw8 wire at an odd slab of 5 windows and on the int16 wire at
the adaptive slab, with the port's own query spectra and with the JAX
scanner's carried over. Shape: sr 8000, 1 s chunks, snippets of up to
0.5 s (``fft_len`` 2^14). Raw candidates and final peaks at identical
positions; heights and prominences within 1.2e-5, the reference's oracle
tolerance (tests/test_correlate.py).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from audio_matcher_tpu.models.matcher import MatchConfig as JaxConfig  # noqa: E402
from audio_matcher_tpu.parallel.mesh import make_mesh  # noqa: E402
from audio_matcher_tpu.parallel.sweep import ShardedScanner as JaxScanner  # noqa: E402

from audio_matcher_tpu_torch.models.matcher import (  # noqa: E402
    FFT_IMPLS,
    PEAKS_IMPLS,
    MatchConfig,
    query_state_from_numpy,
)
from audio_matcher_tpu_torch.parallel.sweep import ShardedScanner  # noqa: E402

SR = 8000
TOL = 1.2e-5
PLANTS = {0: [(0, 1.3), (2, 3.7)], 1: [(1, 2.2), (0, 4.05)]}
IMPLS = [(f, p) for f in FFT_IMPLS for p in PEAKS_IMPLS]
WIRES = {"mulaw8": dict(slab=5, slab_auto=False), "int16": {}}


def _inputs(n_queries):
    rng = np.random.default_rng(2025)
    snippets = [
        (rng.standard_normal(m) * 0.2).astype(np.float32)
        for m in (4000, 3600, 3800)
    ]
    episodes = []
    for e, secs in enumerate((6.5, 5.0)):
        x = (rng.standard_normal(int(secs * SR)) * 0.05).astype(np.float32)
        for q, at in PLANTS[e]:
            i = int(at * SR)
            x[i : i + len(snippets[q])] = snippets[q]
        episodes.append(x)
    return snippets[:n_queries], episodes


def _jax_state(js):
    spec = js._sample_f_resident
    if isinstance(spec, tuple):
        t_r, t_i = (np.asarray(a) for a in spec)
    else:
        t_r, t_i = np.real(np.asarray(spec)), np.imag(np.asarray(spec))
    return t_r, t_i, np.asarray(js._inv_ac), np.asarray(js._m)


@pytest.mark.parametrize("n_queries", [3, 1])
@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("fft_impl,peaks_impl", IMPLS)
def test_scan_impl_matches_jax(fft_impl, peaks_impl, wire, n_queries):
    snippets, episodes = _inputs(n_queries)
    kw = dict(chunk_secs=1.0, transfer_dtype=wire, fft_impl=fft_impl,
              peaks_impl=peaks_impl, **WIRES[wire])
    js = JaxScanner(snippets, SR, JaxConfig(**kw), mesh=make_mesh(1))
    (pos, h, prom), ns, n_real = js.scan_dispatch(js.stage_resident(episodes))
    want_raw = [np.asarray(a) for a in (pos, h, prom)]
    want = js.scan_collect(((pos, h, prom), ns, n_real))
    fin = np.isfinite(want_raw[1])
    for qs in (None, query_state_from_numpy(*_jax_state(js), device="cpu")):
        scanner = ShardedScanner(snippets, SR, MatchConfig(**kw),
                                 device="cpu", query_state=qs)
        assert scanner.fft_impl == js.fft_impl == fft_impl
        dispatched = scanner.scan_dispatch(scanner.stage_resident(episodes))
        got_raw = [a.numpy() for a in dispatched[0]]
        assert got_raw[0].shape == want_raw[0].shape
        np.testing.assert_array_equal(np.isfinite(got_raw[1]), fin)
        np.testing.assert_array_equal(got_raw[0][fin], want_raw[0][fin])
        for g, w in zip(got_raw[1:], want_raw[1:]):
            np.testing.assert_allclose(g[fin], w[fin], rtol=0, atol=TOL)
        peaks = scanner.scan_collect(dispatched)
        for got_e, want_e in zip(peaks, want):
            for got_q, want_q in zip(got_e, want_e):
                assert ([p.position for p in got_q]
                        == [p.position for p in want_q])
                for a, b in zip(got_q, want_q):
                    assert abs(a.height - b.height) <= TOL
                    assert abs(a.prominence - b.prominence) <= TOL
        for e, plants in PLANTS.items():
            for q, at in plants:
                if q < n_queries:
                    assert int(at * SR) in [p.position for p in peaks[e][q]]
