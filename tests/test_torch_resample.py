"""The port's polyphase resampler (``ops/resample.py``) and the dispatch of
``hostio.decode.resample``, on the CPU.

Within 2e-6 of scipy's float64 ``resample_poly`` at the JAX package's rate
pairs (its ``tests/test_resample.py`` bound) and of the JAX
``resample_poly_device``; the filter taps byte for byte; the identity rate
exact; the int16 wire within 1; scipy's lengths at the JAX package's
bucket-boundary cases; 2-D batches. ``auto`` resolves from the caller's
device (scipy on the CPU), ``device`` runs the torch path, an unknown impl
raises; the caller's cuDNN TF32 flag and matmul precision survive a call.
"""

import math

import numpy as np
import pytest
import scipy.signal

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from audio_matcher_tpu.ops import resample as jresample  # noqa: E402

from audio_matcher_tpu_torch.hostio import decode  # noqa: E402
from audio_matcher_tpu_torch.ops import resample  # noqa: E402

TOL = 2e-6
RATES = [(44100, 48000), (48000, 44100), (8000, 16000), (22050, 8000)]


def _scipy(x, sr_from, sr_to):
    g = math.gcd(sr_from, sr_to)
    return scipy.signal.resample_poly(
        x.astype(np.float64), sr_to // g, sr_from // g, axis=-1
    ).astype(np.float32)


@pytest.mark.parametrize("sr_from,sr_to", RATES)
def test_matches_scipy_and_jax(sr_from, sr_to):
    x = np.random.default_rng(sr_from).standard_normal(33333).astype(
        np.float32)
    want = _scipy(x, sr_from, sr_to)
    got = resample.resample_poly_device(x, sr_from, sr_to,
                                        device="cpu").numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < TOL
    jax_got = np.asarray(jresample.resample_poly_device(x, sr_from, sr_to))
    assert np.abs(got - jax_got).max() < TOL
    g = math.gcd(sr_from, sr_to)
    up, down = sr_to // g, sr_from // g
    assert (resample._poly_filter(up, down).tobytes()
            == jresample._poly_filter(up, down).tobytes())


def test_identity_rate_is_exact():
    x = np.random.default_rng(0).standard_normal(100).astype(np.float32)
    got = resample.resample_poly_device(x, 8000, 8000, device="cpu")
    np.testing.assert_array_equal(got.numpy(), x)


def test_wire_int16_within_one():
    x = (np.random.default_rng(3).standard_normal(12345) * 0.12).astype(
        np.float32)
    f = resample.resample_poly_device(x, 44100, 48000, device="cpu").numpy()
    w = resample.resample_poly_device(x, 44100, 48000, wire_int16=True,
                                      device="cpu").numpy()
    assert w.dtype == np.int16
    want = np.clip(np.round(f * 65535.0), -32768, 32767).astype(np.int16)
    assert np.abs(w.astype(np.int32) - want.astype(np.int32)).max() <= 1
    jw = np.asarray(jresample.resample_poly_device(x, 44100, 48000,
                                                   wire_int16=True))
    assert np.abs(w.astype(np.int32) - jw.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("n,sr_from,sr_to", [
    (1024, 16000, 48000), (1000, 8000, 48000), (8, 8000, 48000),
    (4410, 44100, 48000), (5120, 8000, 12000), (1, 48000, 44100)])
def test_lengths_match_scipy(n, sr_from, sr_to):
    x = (np.random.default_rng(n).standard_normal(n) * 0.1).astype(
        np.float32)
    want = _scipy(x, sr_from, sr_to)
    got = resample.resample_poly_device(x, sr_from, sr_to,
                                        device="cpu").numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < TOL


def test_batched_2d():
    xb = (np.random.default_rng(4).standard_normal((3, 1024)) * 0.1).astype(
        np.float32)
    got = resample.resample_poly_device(xb, 16000, 48000,
                                        device="cpu").numpy()
    want = _scipy(xb, 16000, 48000)
    assert got.shape == want.shape == (3, 3072)
    assert np.abs(got - want).max() < TOL
    for row, x in zip(got, xb):
        alone = resample.resample_poly_device(x, 16000, 48000, device="cpu")
        np.testing.assert_array_equal(row, alone.numpy())


def test_decode_resample_dispatch(monkeypatch):
    x = (np.random.default_rng(6).standard_normal(3000) * 0.1).astype(
        np.float32)
    scipy_out = decode.resample(x, 8000, 12000, "scipy")
    assert decode.resolve_resample_impl("auto", torch.device("cpu")) == (
        "scipy")
    assert decode.resolve_resample_impl("auto") == "scipy"
    assert decode.resolve_resample_impl("auto", "cuda:0") == "device"
    calls = []
    real = decode.resample_poly_device
    monkeypatch.setattr(decode, "resample_poly_device",
                        lambda *a, **k: (calls.append(k), real(*a, **k))[1])
    np.testing.assert_array_equal(
        decode.resample(x, 8000, 12000, "auto", device="cpu"), scipy_out)
    assert not calls
    got = decode.resample(x, 8000, 12000, "device", device="cpu")
    assert calls and calls[0]["device"] == "cpu"
    assert got.dtype == np.float32 and got.shape == scipy_out.shape
    assert np.abs(got - scipy_out).max() < TOL
    w = decode.resample(x, 8000, 12000, "device", wire_int16=True,
                        device="cpu")
    ws = decode.resample(x, 8000, 12000, "scipy", wire_int16=True)
    assert w.dtype == ws.dtype == np.int16
    assert np.abs(w.astype(int) - ws.astype(int)).max() <= 1
    # the int16 wire as input is read on the reference PCM scale
    xi = np.clip(np.round(x * 65535.0), -32768, 32767).astype(np.int16)
    assert np.abs(decode.resample(xi, 8000, 12000, "device", device="cpu")
                  - got).max() < 1e-4
    with pytest.raises(ValueError, match="impl"):
        decode.resample(x, 8000, 12000, "fftw")


@pytest.mark.parametrize("tf32,precision", [(True, "medium"),
                                            (False, "high")])
def test_settings_are_restored(tf32, precision):
    prev = (torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision(precision)
    try:
        x = np.random.default_rng(8).standard_normal(4000).astype(np.float32)
        got = resample.resample_poly_device(x, 48000, 44100, device="cpu")
        assert torch.backends.cudnn.allow_tf32 == tf32
        assert torch.get_float32_matmul_precision() == precision
        assert np.abs(got.numpy() - _scipy(x, 48000, 44100)).max() < TOL
    finally:
        torch.backends.cudnn.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])
