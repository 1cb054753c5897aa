"""The port's single-query matcher against the JAX package's, on the CPU.

Both scan the same episodes with one snippet (JAX: ``SnippetMatcher`` with
``fft_impl="vpu"``, ``peaks_impl="pallas"``, Pallas in interpret mode;
the port: every kernel's plain PyTorch version, since the tensors lie on
the CPU). Shape: sr 8000, 1 s chunks, a 0.5 s snippet (``fft_len`` =
2^14), distance 1 s. Positions must be identical; heights and
prominences agree within 1.2e-5, the reference's oracle tolerance
(tests/test_correlate.py). Unscaled runs (``scale=False``) hold values
1/inv_autocorr times larger, so their tolerance is 1.2e-5/inv_autocorr.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from audio_matcher_tpu.models import matcher as JM  # noqa: E402

import audio_matcher_tpu_torch as port  # noqa: E402
from audio_matcher_tpu_torch.models import matcher as TM  # noqa: E402

SR = 8000
TOL = 1.2e-5
PLANTS = (1.3, 3.7)


def _inputs():
    rng = np.random.default_rng(77)
    snippet = (rng.standard_normal(4000) * 0.2).astype(np.float32)
    episodes = []
    for secs in (6.5, 4.2):
        x = (rng.standard_normal(int(secs * SR)) * 0.05).astype(np.float32)
        for at in PLANTS[: 2 if secs > 5 else 1]:
            x[int(at * SR) : int(at * SR) + len(snippet)] = snippet
        episodes.append(x)
    return snippet, episodes


def _configs(wire, **kw):
    kw = dict(chunk_secs=1.0, distance_secs=1.0, transfer_dtype=wire, **kw)
    return (
        JM.MatchConfig(fft_impl="vpu", peaks_impl="pallas", **kw),
        TM.MatchConfig(**kw),
    )


def _matchers(wire, **kw):
    snippet, episodes = _inputs()
    jcfg, cfg = _configs(wire, **kw)
    jm = JM.SnippetMatcher(snippet, SR, jcfg)
    tm = TM.SnippetMatcher(snippet, SR, cfg, device="cpu")
    assert jm.fft_len == tm.fft_len == 1 << 14
    assert jm.fft_impl == tm.fft_impl == "vpu"
    return jm, tm, episodes


def _assert_peaks(got, want, tol=TOL):
    assert [p.position for p in got] == [p.position for p in want]
    for a, b in zip(got, want):
        assert abs(a.height - b.height) <= tol
        assert abs(a.prominence - b.prominence) <= tol


def _raw(m, mod, staged, scale=True):
    """Both packages' whole-episode scan of a staged episode, with the
    arguments ``match_staged`` gives it → numpy (pos, h, prom) (the port:
    the one resident step at Q = 1, through ``SnippetMatcher._scan``)."""
    episode, n = staged
    n_pad = (episode.shape[0] - m.overlap) // m.chunk
    B = mod.effective_slab(m.config, max(-(-n // m.chunk), 1))
    if mod is TM:
        out = m._scan(episode[None], [n], scale, B, n_pad // B)
        return tuple(np.asarray(a[0, 0]) for a in out)
    out = JM._match_episode_resident(
        JM._joined(episode), n, m._sample_f,
        np.float32(m.snippet.inv_autocorr if scale else 1.0),
        chunk=m.chunk, window=m.window, m=m.snippet.m, fft_len=m.fft_len,
        valid_max=m.valid, distance=m.distance_samples, n_peaks=m.n_peaks,
        block=m.config.block, slab=B, n_slabs=n_pad // B,
        fft_impl=m.fft_impl, peaks_impl=m.config.peaks_impl,
    )
    return tuple(np.asarray(a) for a in out)


def _assert_raw(got, want, tol=TOL):
    pos, h, prom = got
    assert pos.shape == want[0].shape
    np.testing.assert_array_equal(np.isfinite(h), np.isfinite(want[1]))
    fin = np.isfinite(want[1])
    np.testing.assert_array_equal(pos[fin], want[0][fin])
    np.testing.assert_allclose(h[fin], want[1][fin], rtol=0, atol=tol)
    np.testing.assert_allclose(prom[fin], want[2][fin], rtol=0, atol=tol)


WIRES = ["mulaw8", "int16"]


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("slab", [8, 5], ids=["slab8", "odd-slab5"])
def test_match_staged_matches_jax(wire, slab):
    """Raw candidates and final peaks; slab 5 (not adapted) makes every
    slab odd, so the last window pair packs the silence pad."""
    jm, tm, episodes = _matchers(wire, slab=slab, slab_auto=False)
    staged = tm.stage(episodes[0])
    j_staged = jm.stage(episodes[0])
    np.testing.assert_array_equal(staged[0].numpy(), np.asarray(j_staged[0]))
    _assert_raw(_raw(tm, TM, staged), _raw(jm, JM, j_staged))
    peaks = tm.match_staged(staged)
    _assert_peaks(peaks, jm.match_staged(j_staged))
    assert [p.position for p in peaks] == [int(a * SR) for a in PLANTS]


@pytest.mark.parametrize("wire", WIRES)
def test_match_staged_batch_matches_jax(wire):
    """Two episodes of different length in one staged batch."""
    jm, tm, episodes = _matchers(wire)
    staged = tm.stage_batch(episodes)
    j_staged = jm.stage_batch(episodes)
    np.testing.assert_array_equal(staged[0].numpy(), np.asarray(j_staged[0]))
    got = tm.match_staged_batch(staged)
    want = jm.match_staged_batch(j_staged)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_peaks(g, w)
    # each row scans as the episode alone does
    _assert_peaks(got[1], tm.match_staged(tm.stage(episodes[1])))


@pytest.mark.parametrize("wire", WIRES)
def test_live_progress_matches_jax(wire):
    """Two slabs in groups of one: the same ("start"|"finish", window)
    sequence as the JAX package (a group's starts before its finishes),
    and the same peaks as the one-call path."""
    jm, tm, episodes = _matchers(
        wire, slab=4, slab_auto=False, progress_slabs_per_dispatch=1
    )
    got_calls, want_calls = [], []
    got = tm.match(episodes[0], progress=lambda *a: got_calls.append(a))
    want = jm.match(episodes[0], progress=lambda *a: want_calls.append(a))
    assert got_calls == want_calls
    assert got_calls[:5] == [("start", k) for k in range(4)] + [("finish", 0)]
    _assert_peaks(got, want)
    _assert_peaks(got, tm.match(episodes[0]), tol=0.0)


@pytest.mark.parametrize("wire", WIRES)
def test_unscaled_matches_jax(wire):
    jm, tm, episodes = _matchers(wire)
    tol = TOL / tm.snippet.inv_autocorr
    staged, j_staged = tm.stage(episodes[0]), jm.stage(episodes[0])
    _assert_raw(
        _raw(tm, TM, staged, scale=False), _raw(jm, JM, j_staged, scale=False),
        tol=tol,
    )
    got = tm.match_staged(staged, scale=False)
    _assert_peaks(got, jm.match_staged(j_staged, scale=False), tol=tol)
    assert got and got[0].height > 100 * tm.match_staged(staged)[0].height


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("secs", [3.0, 8.25], ids=["truncate", "extend"])
def test_n_samples_matches_jax(wire, secs):
    jm, tm, episodes = _matchers(wire)
    n = int(secs * SR)
    staged = tm.stage(episodes[0], n_samples=n)
    assert staged[1] == n
    np.testing.assert_array_equal(
        staged[0].numpy(), np.asarray(jm.stage(episodes[0], n_samples=n)[0])
    )
    _assert_peaks(
        tm.match(episodes[0], n_samples=n), jm.match(episodes[0], n_samples=n)
    )


def test_match_finds_the_plant_and_equals_the_matcher():
    snippet, episodes = _inputs()
    kw = dict(chunk_secs=1.0, distance_secs=1.0, transfer_dtype="int16")
    peaks = port.match(snippet, episodes[0], SR, device="cpu", **kw)
    assert [p.position for p in peaks] == [int(a * SR) for a in PLANTS]
    assert peaks[0].height > 0.9
    matcher = TM.SnippetMatcher(snippet, SR, TM.MatchConfig(**kw),
                                device="cpu")
    _assert_peaks(peaks, matcher.match(episodes[0]), tol=0.0)
    _assert_peaks(
        TM.calc_chunks(SR, episodes[0], snippet, config=TM.MatchConfig(**kw),
                       device="cpu"),
        peaks, tol=0.0,
    )
    assert port.offset_range((3, 9), 10) == (13, 19)
    empty = TM.SnippetMatcher(snippet, SR, device="cpu")
    assert empty.match_staged(empty.stage(np.zeros(0, np.float32))) == []


def test_matcher_geometry_matches_jax():
    """Overlap, the snippet-length raise, n_peaks and its cap."""
    snippet, _ = _inputs()
    for kw in (
        dict(chunk_secs=1.0),
        dict(chunk_secs=0.25, overlap_secs=0.1),  # raised to the snippet
        dict(chunk_secs=1.0, distance_secs=0.0, max_peaks_per_chunk=5),
    ):
        jm = JM.SnippetMatcher(snippet, SR, JM.MatchConfig(**kw))
        tm = TM.SnippetMatcher(snippet, SR, TM.MatchConfig(**kw),
                               device="cpu")
        for attr in ("overlap", "chunk", "window", "valid", "fft_len",
                     "distance_samples", "n_peaks"):
            assert getattr(tm, attr) == getattr(jm, attr), (kw, attr)


def test_matcher_refuses_off_slice_configurations():
    """Every ``fft_impl`` × ``peaks_impl`` of the JAX package constructs;
    unknown names raise, and so does a ``"vpu"`` matcher above fft_len
    2^28 on a CUDA device (and only there: 2^28 constructs)."""
    snippet, _ = _inputs()
    for fft_impl in TM.FFT_IMPLS:
        for peaks_impl in TM.PEAKS_IMPLS:
            m = TM.SnippetMatcher(snippet, SR, TM.MatchConfig(
                chunk_secs=1.0, fft_impl=fft_impl, peaks_impl=peaks_impl))
            assert m.fft_impl == fft_impl
    for kw in (dict(fft_impl="fftw"), dict(peaks_impl="scipy")):
        with pytest.raises(ValueError, match=next(iter(kw))):
            TM.SnippetMatcher(snippet, SR, TM.MatchConfig(**kw))
    huge = TM.MatchConfig(chunk_secs=34000.0)  # fft_len 2^29
    with pytest.raises(ValueError, match="2\\^28"):
        TM.SnippetMatcher(snippet, SR, huge)
    assert TM.SnippetMatcher(snippet, SR, huge, device="cpu").fft_len == 1 << 29
    for secs, e in ((2200.0, 25), (30000.0, 28)):  # the card runs these
        m = TM.SnippetMatcher(snippet, SR, TM.MatchConfig(chunk_secs=secs))
        assert (m.fft_len, m.fft_impl) == (1 << e, "vpu")


def test_entry_points_default_to_cuda():
    """With no ``device`` the entry points target the current CUDA
    device; constructing allocates nothing, and without a card staging
    raises torch's own error instead of falling back to the CPU."""
    snippet, episodes = _inputs()
    from audio_matcher_tpu_torch.parallel.sweep import ShardedScanner

    assert TM.SnippetMatcher(snippet, SR).device.type == "cuda"
    assert ShardedScanner([snippet], SR).device.type == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    cfg = TM.MatchConfig(chunk_secs=1.0)
    for call in (
        lambda: port.match(snippet, episodes[0], SR, chunk_secs=1.0),
        lambda: TM.calc_chunks(SR, episodes[0], snippet, config=cfg),
        lambda: ShardedScanner([snippet], SR, cfg).scan_resident(episodes),
    ):
        with pytest.raises((RuntimeError, AssertionError)):
            call()


@pytest.mark.parametrize("wire", WIRES)
def test_small_fft_fallback_matches_jax(wire):
    """A 0.125 s snippet in 0.25 s chunks gives ``fft_len`` 4096 < 2^14:
    both matchers take ``xla_packed`` with the dense single-read peaks
    (the episode dequantized on the device, window pairs packed), through
    the one-call, batch and live paths."""
    rng = np.random.default_rng(12)
    snippet = (rng.standard_normal(1000) * 0.2).astype(np.float32)
    episodes = []
    for secs, at in ((2.3, 0.4), (1.7, 1.1)):
        x = (rng.standard_normal(int(secs * SR)) * 0.05).astype(np.float32)
        x[int(at * SR) : int(at * SR) + len(snippet)] = snippet
        episodes.append(x)
    kw = dict(chunk_secs=0.25, distance_secs=1.0, transfer_dtype=wire,
              slab=4, slab_auto=False, progress_slabs_per_dispatch=2)
    jm = JM.SnippetMatcher(
        snippet, SR, JM.MatchConfig(fft_impl="vpu", peaks_impl="pallas", **kw)
    )
    tm = TM.SnippetMatcher(snippet, SR, TM.MatchConfig(**kw), device="cpu")
    assert jm.fft_impl == tm.fft_impl == "xla_packed"
    assert tm.fft_len == 4096
    staged, j_staged = tm.stage(episodes[0]), jm.stage(episodes[0])
    _assert_raw(_raw(tm, TM, staged), _raw(jm, JM, j_staged))
    peaks = tm.match_staged(staged)
    _assert_peaks(peaks, jm.match_staged(j_staged))
    assert int(0.4 * SR) in [p.position for p in peaks]
    got = tm.match_staged_batch(tm.stage_batch(episodes))
    for g, w in zip(got, jm.match_staged_batch(jm.stage_batch(episodes))):
        _assert_peaks(g, w)
    calls = []
    _assert_peaks(
        tm.match(episodes[0], progress=lambda *a: calls.append(a)), peaks,
        tol=0.0,
    )
    assert calls[:9] == [("start", k) for k in range(8)] + [("finish", 0)]
