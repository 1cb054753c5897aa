"""The entry points whose scans the step cache now replays, on the CPU:
``SnippetMatcher.match_staged_batch``, repeated ``calc_chunks`` and
``match()`` (one cache for the process, the query spectrum copied into
the graph), ``SpectrogramMatcher.match`` and the windows path
``ShardedScanner.scan``.

The CPU is graphed by ``test_torch_step_graph.py``'s stub graph (the
``stub`` fixture): three calls of one shape are a first sight (eager), a
capture with its replay, and a replay. Every call's peaks equal the JAX
package's on the same seeded inputs (Pallas in interpret mode): positions
identical, heights and prominences within 1.2e-5 (2e-4 in spectrogram
mode). Shapes: sr 8000, fft_len 2^14. GPU tests (``test_torch_gpu.py``)
hold the real graphs against the eager paths, bitwise.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import audio_matcher_tpu as jax_port  # noqa: E402
from audio_matcher_tpu.models import matcher as JM  # noqa: E402
from audio_matcher_tpu.models import spectrogram as JS  # noqa: E402
from audio_matcher_tpu.parallel.mesh import make_mesh  # noqa: E402
from audio_matcher_tpu.parallel.sweep import ShardedScanner as JaxScanner  # noqa: E402
from test_torch_step_graph import (  # noqa: E402,F401
    SR,
    TOL,
    TOL_SPEC,
    _harmonic_snippet,
    _inputs,
    stub,
)

import audio_matcher_tpu_torch as port  # noqa: E402
from audio_matcher_tpu_torch.models import matcher as TM  # noqa: E402
from audio_matcher_tpu_torch.models.spectrogram import (  # noqa: E402
    SpectrogramConfig,
    SpectrogramMatcher,
)
from audio_matcher_tpu_torch.ops import stft  # noqa: E402
from audio_matcher_tpu_torch.parallel import step_graph  # noqa: E402
from audio_matcher_tpu_torch.parallel.step_graph import StepGraphs  # noqa: E402
from audio_matcher_tpu_torch.parallel.sweep import ShardedScanner  # noqa: E402

ONCE_EACH = {"first": 1, "captures": 1, "hits": 1}


def _same(got, want, tol=TOL):
    assert [p.position for p in got] == [p.position for p in want]
    for a, b in zip(got, want):
        assert abs(a.height - b.height) <= tol
        assert abs(a.prominence - b.prominence) <= tol


def _match_kw(wire):
    return dict(chunk_secs=1.0, distance_secs=1.0, transfer_dtype=wire)


@pytest.mark.parametrize("wire", ["mulaw8", "int16"])
def test_match_staged_batch_replays_and_matches_jax(wire, stub):
    """Two episodes of different lengths in one staged batch, scanned
    three times by one matcher: first sight, capture, replay, each with
    the JAX matcher's peaks; the row lengths go in as a device tensor."""
    snippets, episodes = _inputs()
    kw = _match_kw(wire)
    jm = JM.SnippetMatcher(snippets[0], SR, JM.MatchConfig(
        fft_impl="vpu", peaks_impl="pallas", **kw))
    want = jm.match_staged_batch(jm.stage_batch(episodes))
    tm = TM.SnippetMatcher(snippets[0], SR, TM.MatchConfig(**kw),
                           device="cpu")
    staged = tm.stage_batch(episodes)
    for _ in range(3):
        got = tm.match_staged_batch(staged)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _same(g, w)
    assert dict(tm.step_graphs.stats) == ONCE_EACH
    assert int(1.3 * SR) in [p.position for p in got[0]]


@pytest.fixture
def call_graphs(stub, monkeypatch):
    """A fresh process-wide cache of ``calc_chunks`` and ``match()``."""
    cache = StepGraphs()
    monkeypatch.setattr(TM, "CALL_GRAPHS", cache)
    return cache


@pytest.mark.parametrize("wire", ["mulaw8", "int16"])
def test_repeated_calc_chunks_replay_and_match_jax(wire, call_graphs):
    """Each ``calc_chunks`` call builds its own matcher; the second call
    of one shape captures and the third replays, through the shared
    cache, with the JAX package's peaks every time."""
    snippets, episodes = _inputs()
    kw = _match_kw(wire)
    want = JM.calc_chunks(SR, episodes[0], snippets[0], config=JM.MatchConfig(
        fft_impl="vpu", peaks_impl="pallas", **kw))
    for _ in range(3):
        got = TM.calc_chunks(SR, episodes[0], snippets[0],
                             config=TM.MatchConfig(**kw), device="cpu")
        _same(got, want)
    assert dict(call_graphs.stats) == ONCE_EACH
    assert int(1.3 * SR) in [p.position for p in got]


@pytest.mark.parametrize("wire", ["mulaw8", "int16"])
def test_match_with_another_snippet_of_one_length_replays_its_peaks(
        wire, call_graphs):
    """``match()`` with snippet A, then A, then B (another snippet of A's
    length, planted elsewhere): the third call replays the graph the
    second captured and returns B's peaks, equal to the JAX package's for
    B — the spectrum is copied into the graph, not held from A's call."""
    rng = np.random.default_rng(31)
    a, b = ((rng.standard_normal(4000) * 0.2).astype(np.float32)
            for _ in range(2))
    episode = (rng.standard_normal(int(6.5 * SR)) * 0.05).astype(np.float32)
    for snip, at in ((a, 1.3), (b, 3.7)):
        episode[int(at * SR) : int(at * SR) + len(snip)] = snip
    kw = dict(_match_kw(wire), fft_impl="vpu", peaks_impl="pallas")
    runs = [(snip, port.match(snip, episode, SR, device="cpu", **kw))
            for snip in (a, a, b)]
    assert dict(call_graphs.stats) == ONCE_EACH
    for snip, got in runs:
        _same(got, jax_port.match(snip, episode, SR, **kw))
    best = [max(got, key=lambda p: p.height).position for _, got in runs]
    assert best == [int(1.3 * SR), int(1.3 * SR), int(3.7 * SR)]


def test_match_graphs_go_with_a_dropped_cache_and_capture_again(
        call_graphs):
    """``match()``'s graph goes when another cache that kept a graph on
    the device is dropped (so the shared pool can go); the next call of
    its shape captures again, with the JAX package's peaks."""
    snippets, episodes = _inputs()
    kw = dict(_match_kw("mulaw8"), fft_impl="vpu", peaks_impl="pallas")
    want = jax_port.match(snippets[0], episodes[0], SR, **kw)
    for _ in range(2):
        _same(port.match(snippets[0], episodes[0], SR, device="cpu", **kw),
              want)
    kept = TM.SnippetMatcher(snippets[1], SR, TM.MatchConfig(**kw),
                             device="cpu")
    for _ in range(2):
        kept.match(episodes[1])
    assert kept.step_graphs.stats["captures"] == 1
    del kept
    assert not step_graph._DEVICES[torch.device("cpu")].graphs
    _same(port.match(snippets[0], episodes[0], SR, device="cpu", **kw), want)
    assert dict(call_graphs.stats) == {"first": 1, "captures": 2}


def _spectrogram_inputs():
    """test_torch_spectrogram.py's matcher inputs at sr 8000: 60 s of
    noise with the harmonic snippet added at 20 s and 41.5 s."""
    rng = np.random.default_rng(1234)
    snippet = _harmonic_snippet(3.0)
    x = (rng.standard_normal(60 * SR) * 0.05).astype(np.float32)
    for at in (20.0, 41.5):
        x[int(at * SR) : int(at * SR) + len(snippet)] += snippet
    return snippet, x + (rng.standard_normal(len(x)) * 0.05).astype(
        np.float32)


@pytest.mark.parametrize("tile", [None, 512], ids=["whole", "tiled"])
def test_spectrogram_matcher_replays_and_matches_jax(tile, stub,
                                                     monkeypatch):
    """``SpectrogramMatcher.match`` three times on one episode: first
    sight, capture, replay, each with the JAX matcher's peaks. The NCC
    runs whole, or in tiles of 512 frames (``NCC_TILE`` made small, so
    that the tiled path reads its frame count from the device)."""
    if tile is not None:
        monkeypatch.setattr(stft, "NCC_TILE", tile)
    snippet, episode = _spectrogram_inputs()
    kw = dict(distance_secs=10.0, min_score=0.1)
    want = JS.SpectrogramMatcher(snippet, SR, JS.SpectrogramConfig(
        **kw)).match(episode)
    matcher = SpectrogramMatcher(snippet, SR, SpectrogramConfig(**kw),
                                 device="cpu")
    n_frames = stft.n_frames_of(len(episode), 1024, 256)
    assert (n_frames - matcher.snippet_fp.shape[0] + 1
            > stft.NCC_TILE) == (tile is not None)
    for _ in range(3):
        got = matcher.match(episode)
        _same(got, want, TOL_SPEC)
    assert dict(matcher.step_graphs.stats) == ONCE_EACH
    best = sorted(got, key=lambda p: -p.height)[:2]
    assert sorted(abs(p.position - int(t * SR)) <= 256 for p, t in zip(
        sorted(best, key=lambda p: p.position), (20.0, 41.5))) == [True, True]
    assert matcher.match(episode[: len(snippet) // 2]) == []


def test_spectrogram_matcher_past_the_device_slots_uses_scipy(stub):
    """A frame distance of 1 leaves more than 256 candidate slots: the
    step ends at the scores, which scipy picks on the host, and the JAX
    matcher's peaks still come back, call after call."""
    snippet, episode = _spectrogram_inputs()
    kw = dict(distance_secs=0.01, min_score=0.3)
    want = JS.SpectrogramMatcher(snippet, SR, JS.SpectrogramConfig(
        **kw)).match(episode)
    matcher = SpectrogramMatcher(snippet, SR, SpectrogramConfig(**kw),
                                 device="cpu")
    assert matcher.config.frame_distance(SR) == 1
    for _ in range(3):
        _same(matcher.match(episode), want, TOL_SPEC)
    assert dict(matcher.step_graphs.stats) == ONCE_EACH
    assert want


def test_windows_scan_replays_and_matches_jax(stub):
    """The windows path ``scan()``, three times on one batch: first sight,
    capture, replay, each with the JAX windows path's peaks; unscaled
    too (the scales are a copied input: the same graph)."""
    snippets, episodes = _inputs()
    kw = dict(chunk_secs=1.0, distance_secs=1.0, block=256)
    js = JaxScanner(snippets, SR, JM.MatchConfig(**kw), mesh=make_mesh(1))
    want = js.scan(episodes)
    scanner = ShardedScanner(snippets, SR, TM.MatchConfig(**kw),
                             device="cpu")
    for _ in range(3):
        got = scanner.scan(episodes)
        for g_e, w_e in zip(got, want):
            for g, w in zip(g_e, w_e):
                _same(g, w)
    assert dict(scanner.step_graphs.stats) == ONCE_EACH
    inv = np.asarray(js._inv_ac)
    for g_e, w_e in zip(scanner.scan(episodes, scale=False),
                        js.scan(episodes, scale=False)):
        for q, (g, w) in enumerate(zip(g_e, w_e)):
            _same(g, w, TOL / inv[q])
    assert scanner.step_graphs.stats["hits"] == 2
    assert int(3.7 * SR) in [p.position for p in got[0][2]]
