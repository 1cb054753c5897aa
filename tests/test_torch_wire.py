"""The port's host seams and wire decode against the JAX package's.

Inputs come from numpy seeds; JAX runs on the CPU. Host-side numpy code
(quantize_wire, the slab policy, overshadow_filter, ...) must agree
exactly; the device decode of the μ-law wire agrees to one ulp of its
``exp()`` (XLA's CPU ``exp`` and PyTorch's differ by up to one ulp on a few
codes, and ``exp()-1`` carries that step into the decoded value).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from audio_matcher_tpu.models import matcher as JM  # noqa: E402
from audio_matcher_tpu.ops.correlate import (  # noqa: E402
    fft_length as jax_fft_length,
    full_spectrum as jax_full_spectrum,
    prepare_snippet as jax_prepare_snippet,
)
from audio_matcher_tpu.ops.peaks import Peak as JPeak  # noqa: E402
from audio_matcher_tpu.ops.wire import dequant_to_f32 as jax_dequant  # noqa: E402

from audio_matcher_tpu_torch.models import matcher as TM  # noqa: E402
from audio_matcher_tpu_torch.ops import correlate as TC  # noqa: E402
from audio_matcher_tpu_torch.ops.peaks import Peak  # noqa: E402
from audio_matcher_tpu_torch.ops.wire import dequant_to_f32  # noqa: E402


def test_mulaw_decode_all_codes_within_one_ulp_of_exp():
    codes = np.arange(256, dtype=np.uint8)
    want = np.asarray(jax_dequant(jnp.asarray(codes)))
    got = dequant_to_f32(torch.from_numpy(codes)).numpy()
    assert got.dtype == np.float32
    # one ulp of exp(|b|·ln(1+μ)), carried through −1, ·1/μ and the scale
    b = codes.astype(np.float32) * np.float32(1 / 127.5) - np.float32(1)
    e = np.exp(np.abs(b).astype(np.float64) * np.log1p(255.0))
    ulp_exp = np.spacing(e.astype(np.float32)).astype(np.float64)
    bound = ulp_exp / 255.0 * (32768.0 / 65535.0) + np.spacing(np.abs(want))
    assert np.all(np.abs(got.astype(np.float64) - want) <= bound)
    # the expansion is exp()-1, not expm1: the grid matches the JAX one
    np.testing.assert_array_equal(np.sign(got), np.sign(want))


def test_int16_decode_exact():
    x = np.random.default_rng(5).integers(
        -32768, 32768, 100_000
    ).astype(np.int16)
    x[:2] = (-32768, 32767)
    want = np.asarray(jax_dequant(jnp.asarray(x)))
    got = dequant_to_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_f32_decode_is_identity():
    x = np.random.default_rng(6).standard_normal(1000).astype(np.float32)
    np.testing.assert_array_equal(dequant_to_f32(torch.from_numpy(x)), x)


@pytest.mark.parametrize("wire", ["float32", "int16", "mulaw8"])
@pytest.mark.parametrize("source", ["f32", "int16"])
def test_quantize_wire_byte_identical(wire, source):
    rng = np.random.default_rng(7)
    x = np.clip(rng.standard_normal(50_000) * 0.2, -0.6, 0.6).astype(
        np.float32
    )
    x[:4] = (0.0, -0.5, 0.5, 0.7)  # silence, both full scales, clipping
    if source == "int16":
        x = JM.quantize_wire(x, "int16")
    want = JM.quantize_wire(x, wire)
    got = TM.quantize_wire(x, wire)
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def test_quantize_wire_rejects_unknown():
    with pytest.raises(ValueError):
        TM.quantize_wire(np.zeros(4, np.float32), "int8")


def test_ulaw_tables_identical():
    for got, want in zip(TM.ulaw_tables(), JM._ulaw_tables()):
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("wire", ["float32", "int16", "mulaw8"])
def test_wire_silence_buffer_and_pad(wire):
    assert TM.wire_silence(wire) == JM.wire_silence(wire)
    got = TM.wire_buffer((3, 5), wire)
    want = JM.wire_buffer((3, 5), wire)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    ep = TM.quantize_wire(np.linspace(-0.3, 0.3, 77, dtype=np.float32), wire)
    for target in (50, 77, 100):
        want = np.asarray(JM.pad_wire_on_device(jnp.asarray(ep), target))
        got = TM.pad_wire_on_device(torch.from_numpy(ep), target).numpy()
        assert got.tobytes() == want.tobytes()


def test_slab_policy_matches():
    for n in range(1, 200):
        for pref in (1, 4, 5, 8, 16):
            assert TM.pick_slab(n, pref) == JM.pick_slab(n, pref)
            assert TM.divisor_slab(n, pref) == JM._divisor_slab(n, pref)
    cfgs = [
        (TM.MatchConfig(slab=8, slab_auto=a), JM.MatchConfig(slab=8, slab_auto=a))
        for a in (True, False)
    ]
    for tc, jc in cfgs:
        for n in (1, 7, 10, 30, 31, 100):
            assert TM.effective_slab(tc, n) == JM.effective_slab(jc, n)
    for w, c in ((12002, 8000), (3241352, 2646000), (10, 10), (11, 10)):
        assert TM.window_rows(w, c) == JM.window_rows(w, c)


def test_match_config_fields_mirror_jax():
    names = [f.name for f in dataclasses.fields(TM.MatchConfig)]
    assert names == [f.name for f in dataclasses.fields(JM.MatchConfig)]
    for raw in (False, True):
        tc = TM.MatchConfig(prominence=13.0, prominence_is_raw=raw)
        jc = JM.MatchConfig(prominence=13.0, prominence_is_raw=raw)
        assert tc.min_prominence == jc.min_prominence


@pytest.mark.parametrize("base", [0, 2, 5])
def test_windows_from_episode_matches(base):
    rng = np.random.default_rng(base)
    chunk, window, slab = 100, 230, 4
    k = TM.window_rows(window, chunk)
    ep = rng.integers(0, 256, (base + slab + k) * chunk).astype(np.uint8)
    want = np.asarray(
        JM.windows_from_episode(jnp.asarray(ep), base, slab, chunk, window)
    )
    got = TM.windows_from_episode(
        torch.from_numpy(ep), base, slab, chunk, window
    )
    np.testing.assert_array_equal(got.numpy(), want)
    # a row of a staged batch: the view starts at the row's own offset
    batch = torch.from_numpy(np.stack([ep[::-1].copy(), ep]))
    np.testing.assert_array_equal(
        TM.windows_from_episode(batch[1], base, slab, chunk, window).numpy(),
        want,
    )
    short = ep[: (base + slab - 1) * chunk + window - 1]
    with pytest.raises(ValueError):
        TM.windows_from_episode(
            torch.from_numpy(short), base, slab, chunk, window
        )


def test_overshadow_filter_matches():
    rng = np.random.default_rng(11)
    for trial in range(30):
        k = int(rng.integers(0, 25))
        pos = rng.integers(0, 40_000, k)
        pos[: k // 3] = pos[0] if k else pos[: k // 3]  # seam duplicates
        prom = rng.uniform(0, 1, k).astype(np.float32)
        h = rng.uniform(0, 1, k).astype(np.float32)
        args = [(int(p), float(a), float(b)) for p, a, b in zip(pos, h, prom)]
        want = JM.overshadow_filter([JPeak(*a) for a in args], 8000, 1.5)
        got = TM.overshadow_filter([Peak(*a) for a in args], 8000, 1.5)
        assert [dataclasses.astuple(p) for p in got] == [
            dataclasses.astuple(p) for p in want
        ]


def test_snippet_prep_and_lengths_match():
    rng = np.random.default_rng(12)
    for m in (1, 7, 4000):
        s = rng.standard_normal(m).astype(np.float32)
        a, b = TC.prepare_snippet(s), jax_prepare_snippet(s)
        assert a.m == b.m and a.inv_autocorr == b.inv_autocorr
        np.testing.assert_array_equal(a.data, b.data)
    assert TC.prepare_snippet(np.zeros(5)).inv_autocorr == 0.0
    for n in (0, 1, 2, 3, 1000, 16001, 3836701):
        assert TC.fft_length(n) == jax_fft_length(n)


@pytest.mark.parametrize("n", [16, 17])
def test_full_spectrum_matches(n):
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    want = np.asarray(jax_full_spectrum(jnp.fft.rfft(jnp.asarray(x)), n))
    got = TC.full_spectrum(torch.fft.rfft(torch.from_numpy(x)), n).numpy()
    assert got.shape == want.shape == (2, n)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
