"""The port's log-mel STFT and frame NCC (``ops/stft.py``) against the JAX
package's, on the CPU.

The mel filterbank byte for byte; log-mel values within 1e-4 (framing
with ``n_fft % hop`` zero and not, a signal shorter than ``n_fft`` and one
spanning several 4096-frame blocks); the single-shot, tiled (small tiles,
several of them) and multi-query NCC within 2e-4 on the valid lags, the
tolerance of the JAX package's own ``tests/test_spectrogram.py``. The
caller's matmul precision survives the FP32 mel projection.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from audio_matcher_tpu.ops import stft as jstft  # noqa: E402

from audio_matcher_tpu_torch.ops import stft  # noqa: E402

TOL_MEL = 1e-4
TOL_NCC = 2e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n_mels,n_fft,sr", [(64, 1024, 44100),
                                             (32, 512, 16000),
                                             (40, 1000, 22050)])
def test_mel_filterbank_is_byte_equal(n_mels, n_fft, sr):
    want = jstft.mel_filterbank(n_mels, n_fft, sr)
    got = stft.mel_filterbank(n_mels, n_fft, sr)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n_fft,hop,n", [
    (1024, 256, 700),  # shorter than n_fft: one frame of a padded signal
    (1024, 256, 48000),
    (1000, 300, 30000),  # n_fft % hop != 0
    (256, 64, 4096 * 64 * 2 + 777),  # three 4096-frame blocks
])
def test_log_mel_matches_jax(n_fft, hop, n):
    x = (np.random.default_rng(n).standard_normal(n) * 0.1).astype(np.float32)
    want = np.asarray(jstft.log_mel(x, 16000, n_fft, hop, 32))
    got = stft.log_mel(x, 16000, n_fft, hop, 32, device="cpu").numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < TOL_MEL


def _fps(rng, t_e, t_s, m):
    return (rng.standard_normal((t_e, m)).astype(np.float32),
            rng.standard_normal((t_s, m)).astype(np.float32))


def test_ncc_frames_core_matches_jax():
    ep, sn = _fps(np.random.default_rng(5), 3000, 300, 16)
    L = stft.fft_length(3000 + 300 - 1)
    want = np.asarray(jstft.ncc_frames_core(jnp.asarray(ep), jnp.asarray(sn),
                                            L, 300))
    got = stft.ncc_frames_core(_t(ep), _t(sn), L, 300).numpy()
    assert got.shape == want.shape == (3000 - 300 + 1,)
    assert np.abs(got - want).max() < TOL_NCC


@pytest.mark.parametrize("t_e,t_s,tile", [(5000, 300, 512), (612, 100, 256),
                                          (900, 1, 128), (500, 100, 512)])
def test_ncc_frames_tiled_core_matches_jax(t_e, t_s, tile):
    ep, sn = _fps(np.random.default_rng(t_e), t_e, t_s, 8)
    want = np.asarray(jstft.ncc_frames_tiled_core(
        jnp.asarray(ep), jnp.asarray(sn), t_s, tile=tile))
    got = stft.ncc_frames_tiled_core(_t(ep), _t(sn), t_s, tile=tile).numpy()
    assert got.shape == want.shape == (t_e - t_s + 1,)
    tol = TOL_NCC if t_s * 8 >= 32 else 2e-3  # few terms: see the JAX test
    assert np.abs(got - want).max() < tol


def test_ncc_frames_multi_core_matches_jax():
    rng = np.random.default_rng(9)
    t_ss, t_e, m = (40, 25, 64), 700, 16
    ep = rng.standard_normal((t_e, m)).astype(np.float32)
    snips = np.zeros((len(t_ss), max(t_ss), m), np.float32)
    for q, t_s in enumerate(t_ss):
        snips[q, :t_s] = rng.standard_normal((t_s, m))
    want = np.asarray(jstft.ncc_frames_multi_core(
        jnp.asarray(ep), jnp.asarray(snips), t_ss, tile=128))
    got = stft.ncc_frames_multi_core(_t(ep), _t(snips), t_ss,
                                     tile=128).numpy()
    assert got.shape == want.shape == (3, t_e - min(t_ss) + 1)
    for q, t_s in enumerate(t_ss):
        valid = t_e - t_s + 1
        assert np.abs(got[q, :valid] - want[q, :valid]).max() < TOL_NCC


def test_fingerprint_scores_matches_jax_and_refuses_short_episodes():
    """Short and long episodes (past ``NCC_TILE`` lags: the tiled path);
    an episode shorter than the snippet raises."""
    rng = np.random.default_rng(2)
    for t_e in (2000, stft.NCC_TILE + 500):
        ep, sn = _fps(rng, t_e, 120, 4)
        want = np.asarray(jstft.fingerprint_scores(jnp.asarray(ep),
                                                   jnp.asarray(sn)))
        got = stft.fingerprint_scores(_t(ep), _t(sn)).numpy()
        assert got.shape == want.shape == (t_e - 120 + 1,)
        assert np.abs(got - want).max() < TOL_NCC
    ep, sn = _fps(rng, 50, 60, 4)
    with pytest.raises(ValueError, match="shorter"):
        stft.fingerprint_scores(_t(ep), _t(sn))


@pytest.mark.parametrize("precision", ["medium", "high"])
def test_log_mel_restores_the_matmul_precision(precision):
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        x = np.random.default_rng(1).standard_normal(5000).astype(np.float32)
        stft.log_mel(x, 16000, 512, 128, 16, device="cpu")
        assert torch.get_float32_matmul_precision() == precision
    finally:
        torch.set_float32_matmul_precision(prev)
