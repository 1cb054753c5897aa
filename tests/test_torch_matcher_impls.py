"""Every ``fft_impl`` × ``peaks_impl`` of the single-query matcher against
the JAX package's, on the CPU.

The eight pairs of the JAX package's ``MatchConfig`` (``"vpu"``,
``"xla_packed"``, ``"xla"``, ``"mxu"`` × ``"pallas"``, ``"jnp"``) scan the
same episodes through ``SnippetMatcher`` in both packages (JAX: Pallas in
interpret mode; the port: every kernel's plain version, since the tensors
lie on the CPU), on the mulaw8 wire at an odd slab of 5 windows and on the
int16 wire at the adaptive slab. Shape: sr 8000, 1 s chunks, a 0.5 s
snippet (``fft_len`` 2^14), distance 1 s. Raw candidates and final peaks
at identical positions; heights and prominences within 1.2e-5, the
reference's oracle tolerance (tests/test_correlate.py). ``calc_chunks``,
``match()``, the batch and the live-progress paths give the matcher's
peaks exactly, and so does the one-snippet ``ShardedScanner``, which
runs the same resident step at Q = 1.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from audio_matcher_tpu.models import matcher as JM  # noqa: E402

import audio_matcher_tpu_torch as port  # noqa: E402
from audio_matcher_tpu_torch.models import matcher as TM  # noqa: E402
from audio_matcher_tpu_torch.parallel.sweep import ShardedScanner  # noqa: E402

SR = 8000
TOL = 1.2e-5
PLANTS = (1.3, 3.7)
IMPLS = [(f, p) for f in TM.FFT_IMPLS for p in TM.PEAKS_IMPLS]
WIRES = {"mulaw8": dict(slab=5, slab_auto=False), "int16": {}}


def _inputs():
    rng = np.random.default_rng(78)
    snippet = (rng.standard_normal(4000) * 0.2).astype(np.float32)
    episodes = []
    for secs in (6.5, 4.2):
        x = (rng.standard_normal(int(secs * SR)) * 0.05).astype(np.float32)
        for at in PLANTS[: 2 if secs > 5 else 1]:
            x[int(at * SR) : int(at * SR) + len(snippet)] = snippet
        episodes.append(x)
    return snippet, episodes


def _assert_peaks(got, want, tol=TOL):
    assert [p.position for p in got] == [p.position for p in want]
    for a, b in zip(got, want):
        assert abs(a.height - b.height) <= tol
        assert abs(a.prominence - b.prominence) <= tol


def _raw(m, mod, staged):
    """The whole-episode scan of a staged episode (the port: the one
    resident step at Q = 1, through ``SnippetMatcher._scan``)."""
    episode, n = staged
    n_pad = (episode.shape[0] - m.overlap) // m.chunk
    B = mod.effective_slab(m.config, max(-(-n // m.chunk), 1))
    if mod is TM:
        out = m._scan(episode[None], [n], True, B, n_pad // B)
        return [np.asarray(a[0, 0]) for a in out]
    out = JM._match_episode_resident(
        JM._joined(episode), n, m._sample_f,
        np.float32(m.snippet.inv_autocorr),
        chunk=m.chunk, window=m.window, m=m.snippet.m, fft_len=m.fft_len,
        valid_max=m.valid, distance=m.distance_samples, n_peaks=m.n_peaks,
        block=m.config.block, slab=B, n_slabs=n_pad // B,
        fft_impl=m.fft_impl, peaks_impl=m.config.peaks_impl,
    )
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("fft_impl,peaks_impl", IMPLS)
def test_matcher_impl_matches_jax(fft_impl, peaks_impl, wire):
    snippet, episodes = _inputs()
    kw = dict(chunk_secs=1.0, distance_secs=1.0, transfer_dtype=wire,
              fft_impl=fft_impl, peaks_impl=peaks_impl, **WIRES[wire])
    jm = JM.SnippetMatcher(snippet, SR, JM.MatchConfig(**kw))
    tm = TM.SnippetMatcher(snippet, SR, TM.MatchConfig(**kw), device="cpu")
    assert tm.fft_impl == jm.fft_impl == fft_impl and tm.fft_len == 1 << 14
    staged, j_staged = tm.stage(episodes[0]), jm.stage(episodes[0])
    got, want = _raw(tm, TM, staged), _raw(jm, JM, j_staged)
    assert got[0].shape == want[0].shape
    fin = np.isfinite(want[1])
    np.testing.assert_array_equal(np.isfinite(got[1]), fin)
    np.testing.assert_array_equal(got[0][fin], want[0][fin])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g[fin], w[fin], rtol=0, atol=TOL)

    peaks = tm.match_staged(staged)
    n_windows = -(-len(episodes[0]) // tm.chunk)  # match_staged's tail
    _assert_peaks(peaks, jm._extract_peaks(*want, n_windows))
    assert [p.position for p in peaks] == [int(a * SR) for a in PLANTS]
    cfg = TM.MatchConfig(**kw)
    _assert_peaks(port.match(snippet, episodes[0], SR, device="cpu", **kw),
                  peaks, tol=0.0)
    _assert_peaks(TM.calc_chunks(SR, episodes[0], snippet, config=cfg,
                                 device="cpu"), peaks, tol=0.0)
    batch = tm.match_staged_batch(tm.stage_batch(episodes))
    _assert_peaks(batch[0], peaks, tol=0.0)
    _assert_peaks(batch[1], tm.match(episodes[1]), tol=0.0)
    live = TM.SnippetMatcher(snippet, SR, TM.MatchConfig(
        **kw, progress_slabs_per_dispatch=1), device="cpu")
    calls = []
    _assert_peaks(live.match(episodes[0], progress=lambda *a: calls.append(a)),
                  peaks, tol=0.0)
    assert calls[0] == ("start", 0) and len(calls) == 2 * 7


@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("fft_impl,peaks_impl", IMPLS)
def test_matcher_and_one_snippet_scanner_agree(fft_impl, peaks_impl, wire):
    """Both front ends run the one resident step at Q = 1: the matcher's
    peaks and the one-snippet scanner's are identical (tolerance 0)."""
    snippet, episodes = _inputs()
    cfg = TM.MatchConfig(chunk_secs=1.0, distance_secs=1.0,
                         transfer_dtype=wire, fft_impl=fft_impl,
                         peaks_impl=peaks_impl, **WIRES[wire])
    tm = TM.SnippetMatcher(snippet, SR, cfg, device="cpu")
    scanner = ShardedScanner([snippet], SR, cfg, device="cpu")
    assert (scanner.fft_impl, scanner.window) == (tm.fft_impl, tm.window)
    got = tm.match_staged(tm.stage(episodes[0]))
    _assert_peaks(got, scanner.scan_resident([episodes[0]])[0][0], tol=0.0)
    assert [p.position for p in got] == [int(a * SR) for a in PLANTS]
