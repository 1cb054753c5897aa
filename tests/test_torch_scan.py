"""The port's batch scanner against the JAX package's, on the CPU.

Both scan the same staged episodes with the fused path (JAX:
``fft_impl="vpu"``, ``peaks_impl="pallas"`` in Pallas interpret mode on a
one-device mesh; the port: every kernel's plain PyTorch version, since the
tensors lie on the CPU). Shape: sr 8000, 1 s chunks, snippets of up to
0.5 s (``fft_len`` = 2^14), 2 episodes, Q = 3 (odd: the pad query row runs)
and Q = 1; then 0.25 s chunks and 0.125 s snippets, where both scanners
fall back to ``xla_packed`` (``fft_len`` 4096).
Positions must be identical; heights and prominences agree within 1.2e-5,
the reference's oracle tolerance (tests/test_correlate.py): both sides
compute the same f32 transforms by different FFT algorithms, which differ
by about 1e-6 of the largest correlation.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from audio_matcher_tpu.models.matcher import MatchConfig as JaxConfig  # noqa: E402
from audio_matcher_tpu.parallel.mesh import make_mesh  # noqa: E402
from audio_matcher_tpu.parallel.sweep import ShardedScanner as JaxScanner  # noqa: E402

from audio_matcher_tpu_torch.models.matcher import (  # noqa: E402
    MatchConfig,
    query_state_from_numpy,
)
from audio_matcher_tpu_torch.parallel.sweep import ShardedScanner  # noqa: E402

SR = 8000
TOL = 1.2e-5
PLANTS = {0: [(0, 1.3), (2, 3.7)], 1: [(1, 2.2), (0, 4.05)]}


def _inputs():
    rng = np.random.default_rng(2024)
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
    return snippets, episodes


def _configs(wire):
    kw = dict(chunk_secs=1.0, transfer_dtype=wire)
    return (
        JaxConfig(fft_impl="vpu", peaks_impl="pallas", **kw),
        MatchConfig(**kw),
    )


@pytest.fixture(scope="module", params=["mulaw8", "int16"])
def jax_run(request):
    """One JAX scan per wire, shared by the port's variants."""
    wire = request.param
    snippets, episodes = _inputs()
    jcfg, cfg = _configs(wire)
    js = JaxScanner(snippets, SR, jcfg, mesh=make_mesh(1))
    assert js.fft_len == 1 << 14 and js.fft_impl == "vpu"
    staged = js.stage_resident(episodes)
    (pos, h, prom), ns, n_real = js.scan_dispatch(staged)
    raw = tuple(np.asarray(a) for a in (pos, h, prom))
    peaks = js.scan_collect(((pos, h, prom), ns, n_real))
    state = (
        np.asarray(js._sample_f_resident[0]),
        np.asarray(js._sample_f_resident[1]),
        np.asarray(js._inv_ac),
        np.asarray(js._m),
    )
    return wire, snippets, episodes, cfg, raw, peaks, state


def _assert_same(peaks, want):
    assert len(peaks) == len(want)
    for got_e, want_e in zip(peaks, want):
        assert len(got_e) == len(want_e)
        for got_q, want_q in zip(got_e, want_e):
            assert [p.position for p in got_q] == [p.position for p in want_q]
            for a, b in zip(got_q, want_q):
                assert abs(a.height - b.height) <= TOL
                assert abs(a.prominence - b.prominence) <= TOL


def _assert_raw(got, want):
    pos, h, prom = (a.cpu().numpy() for a in got)
    assert pos.shape == want[0].shape
    np.testing.assert_array_equal(np.isfinite(h), np.isfinite(want[1]))
    fin = np.isfinite(want[1])
    np.testing.assert_array_equal(pos[fin], want[0][fin])
    np.testing.assert_allclose(h[fin], want[1][fin], rtol=0, atol=TOL)
    np.testing.assert_allclose(prom[fin], want[2][fin], rtol=0, atol=TOL)


@pytest.mark.parametrize("carried", [False, True], ids=["own", "carried"])
def test_scan_matches_jax(jax_run, carried):
    wire, snippets, episodes, cfg, raw, want, state = jax_run
    qs = query_state_from_numpy(*state, device="cpu") if carried else None
    scanner = ShardedScanner(snippets, SR, cfg, device="cpu", query_state=qs)
    dispatched = scanner.scan_dispatch(scanner.stage_resident(episodes))
    _assert_raw(dispatched[0], raw)
    peaks = scanner.scan_collect(dispatched)
    _assert_same(peaks, want)
    # every plant is found at its sample
    for e, plants in PLANTS.items():
        for q, at in plants:
            assert int(at * SR) in [p.position for p in peaks[e][q]]


def test_pad_rows_match_jax(jax_run):
    """``stage_resident(pad_to=...)`` stages the same silence rows as the
    JAX scanner, the scan of the padded batch gives the unpadded batch's
    candidates on the real rows and none on the pad rows, and collect
    reports only the real episodes."""
    wire, snippets, episodes, cfg, raw, want, state = jax_run
    jcfg, _ = _configs(wire)
    js = JaxScanner(snippets, SR, jcfg, mesh=make_mesh(1))
    j_rows, j_ns, j_real = js.stage_resident(episodes, pad_to=4)
    scanner = ShardedScanner(
        snippets, SR, cfg, device="cpu",
        query_state=query_state_from_numpy(*state, "cpu"),
    )
    staged = scanner.stage_resident(episodes, pad_to=4)
    rows, ns, n_real = staged
    assert rows.shape[0] == 4 and n_real == j_real == len(episodes)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(j_rows))
    np.testing.assert_array_equal(ns, np.asarray(j_ns))
    dispatched = scanner.scan_dispatch(staged)
    pos, h, prom = dispatched[0]
    _assert_raw((pos[:2], h[:2], prom[:2]), raw)
    assert not torch.isfinite(h[2:]).any()
    _assert_same(scanner.scan_collect(dispatched), want)


def test_refuses_off_slice_configurations():
    """Every ``fft_impl`` × ``peaks_impl`` is scanned, one snippet and
    ``fft_len`` < 2^14 too (the tests below), and several devices: two
    shards of the CPU scan exactly as one; above 2^28 a ``"vpu"`` scanner
    on a CUDA device (or a mesh of them) is refused at construction, which
    allocates nothing."""
    snippets, episodes = _inputs()
    for fft_impl in ("vpu", "xla_packed", "xla", "mxu"):
        for peaks_impl in ("pallas", "jnp"):
            cfg = MatchConfig(chunk_secs=1.0, fft_impl=fft_impl,
                              peaks_impl=peaks_impl)
            assert ShardedScanner(snippets, SR, cfg).fft_impl == fft_impl
    with pytest.raises(ValueError, match="fft_impl"):
        ShardedScanner(snippets, SR, MatchConfig(fft_impl="fftw"))
    with pytest.raises(ValueError, match="peaks_impl"):
        ShardedScanner(snippets, SR, MatchConfig(peaks_impl="numpy"))
    single = ShardedScanner(snippets[:1], SR, MatchConfig(chunk_secs=1.0))
    assert single.fft_impl == "vpu" and len(single.queries) == 1
    small = ShardedScanner(
        [s[:1000] for s in snippets], SR, MatchConfig(chunk_secs=0.25)
    )
    assert small.fft_len < 1 << 14 and small.fft_impl == "xla_packed"
    two = ShardedScanner(snippets, SR, MatchConfig(chunk_secs=1.0),
                         device=["cpu", "cpu"])
    assert two.mesh.shape == (2, 1) and two.fft_impl == "vpu"
    one = ShardedScanner(snippets, SR, MatchConfig(chunk_secs=1.0),
                         device="cpu")
    assert two.scan_resident(episodes) == one.scan_resident(episodes)
    huge = MatchConfig(chunk_secs=34000.0)  # fft_len 2^29
    for device in ("cuda", ["cuda:0", "cuda:1"]):
        with pytest.raises(ValueError, match="2\\^28"):
            ShardedScanner(snippets, SR, huge, device=device)
    assert ShardedScanner(snippets, SR, huge, device="cpu").fft_len == 1 << 29
    for cfg in (dataclasses.replace(huge, fft_impl="xla"),
                MatchConfig(chunk_secs=2000.0),  # fft_len 2^24 runs
                MatchConfig(chunk_secs=2200.0),  # and 2^25 ..
                MatchConfig(chunk_secs=30000.0)):  # .. to 2^28
        assert ShardedScanner(snippets, SR, cfg, device="cuda").fft_len


def _jax_scan(snippets, episodes, jcfg):
    """The JAX scanner's raw outputs, peaks and query state (its spectra
    as real and imaginary parts) for a one-device mesh."""
    js = JaxScanner(snippets, SR, jcfg, mesh=make_mesh(1))
    (pos, h, prom), ns, n_real = js.scan_dispatch(js.stage_resident(episodes))
    raw = tuple(np.asarray(a) for a in (pos, h, prom))
    peaks = js.scan_collect(((pos, h, prom), ns, n_real))
    spec = js._sample_f_resident
    if js.fft_impl == "vpu":
        t_r, t_i = (np.asarray(a) for a in spec)
    else:
        t_r, t_i = np.real(np.asarray(spec)), np.imag(np.asarray(spec))
    state = (t_r, t_i, np.asarray(js._inv_ac), np.asarray(js._m))
    return js.fft_impl, raw, peaks, state


@pytest.mark.parametrize("wire", ["mulaw8", "int16"])
def test_single_query_scan_matches_jax(wire):
    """Q = 1 (the config #2 branch): window pairs share each transform,
    with the scanner's own spectra and with the JAX scanner's."""
    snippets, episodes = _inputs()
    jcfg, cfg = _configs(wire)
    impl, raw, want, state = _jax_scan(snippets[:1], episodes, jcfg)
    assert impl == "vpu"
    for qs in (None, query_state_from_numpy(*state, device="cpu")):
        scanner = ShardedScanner(snippets[:1], SR, cfg, device="cpu",
                                 query_state=qs)
        dispatched = scanner.scan_dispatch(scanner.stage_resident(episodes))
        assert dispatched[0][0].shape[:2] == (2, 1)
        _assert_raw(dispatched[0], raw)
        peaks = scanner.scan_collect(dispatched)
        _assert_same(peaks, want)
        assert int(1.3 * SR) in [p.position for p in peaks[0][0]]


@pytest.mark.parametrize("n_queries", [1, 3])
def test_small_fft_fallback_matches_jax(n_queries):
    """Below ``fft_len`` 2^14 both scanners take ``xla_packed`` with the
    dense single-read peaks: window pairs at Q = 1, query pairs at Q = 3."""
    rng = np.random.default_rng(31)
    snippets = [(rng.standard_normal(m) * 0.2).astype(np.float32)
                for m in (1000, 900, 960)][:n_queries]
    episodes = []
    for e, secs in enumerate((2.3, 1.6)):
        x = (rng.standard_normal(int(secs * SR)) * 0.05).astype(np.float32)
        q, at = (0, 0.4) if e == 0 else (n_queries - 1, 1.1)
        x[int(at * SR) : int(at * SR) + len(snippets[q])] = snippets[q]
        episodes.append(x)
    kw = dict(chunk_secs=0.25, distance_secs=1.0, transfer_dtype="mulaw8")
    impl, raw, want, state = _jax_scan(
        snippets, episodes,
        JaxConfig(fft_impl="vpu", peaks_impl="pallas", **kw),
    )
    assert impl == "xla_packed"
    for qs in (None, query_state_from_numpy(*state, device="cpu")):
        scanner = ShardedScanner(
            snippets, SR, MatchConfig(**kw), device="cpu", query_state=qs
        )
        assert scanner.fft_impl == "xla_packed"
        dispatched = scanner.scan_dispatch(scanner.stage_resident(episodes))
        _assert_raw(dispatched[0], raw)
        _assert_same(scanner.scan_collect(dispatched), want)
    assert int(0.4 * SR) in [p.position for p in want[0][0]]
