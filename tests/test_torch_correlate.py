"""The port's ``xla_packed`` correlation against the JAX package's.

Both run the same packed transforms on complex64 FFTs (``jnp.fft`` on the
CPU; ``torch.fft`` here), so arrays agree to the FFTs' rounding: within
3e-6 of the largest reference value, the bound the JAX package's own FFT
oracle uses (tests/test_pallas_fft.py).
"""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from audio_matcher_tpu_torch.ops import correlate as T  # noqa: E402

# the JAX package's ops namespace exports a function named ``correlate``
J = importlib.import_module("audio_matcher_tpu.ops.correlate")

TOL = 3e-6
N = 4096  # the fallback's fft_len at the tests' shapes


def _close(got, want):
    g, w = got.resolve_conj().numpy(), np.asarray(want)
    assert g.shape == w.shape
    assert np.max(np.abs(g - w)) / np.max(np.abs(w)) < TOL


@pytest.mark.parametrize("Q", [1, 2, 3])
def test_packed_query_spectra_match(Q, rng):
    snippets = (rng.standard_normal((Q, 1000)) * 0.2).astype(np.float32)
    want = J.packed_query_spectra(jnp.asarray(snippets), N)
    got = T.packed_query_spectra(torch.from_numpy(snippets), N)
    assert got.dtype == torch.complex64 and got.shape == ((Q + 1) // 2, N)
    _close(got, want)
    if Q == 1:  # the pair row of one query is its conjugated spectrum
        _close(T.query_spectrum(torch.from_numpy(snippets[0]), N)[None], want)


@pytest.mark.parametrize("B", [4, 5])
def test_corr_slab_xla_packed_matches(B, rng):
    windows = (rng.standard_normal((B, 3002)) * 0.1).astype(np.float32)
    snippets = (rng.standard_normal((3, 1000)) * 0.2).astype(np.float32)
    t_j = J.packed_query_spectra(jnp.asarray(snippets), N)
    want = J.corr_slab_xla_packed(jnp.asarray(windows), t_j, 2003)
    got = T.corr_slab_xla_packed(
        torch.from_numpy(windows), torch.from_numpy(np.array(t_j)), 2003
    )
    assert got.dtype == torch.float32 and got.shape == (B, 4, 2003)
    _close(got, want)


@pytest.mark.parametrize("B", [4, 5])
def test_corr_single_query_packed_matches(B, rng):
    windows = (rng.standard_normal((B, 3002)) * 0.1).astype(np.float32)
    snippet = (rng.standard_normal(1000) * 0.2).astype(np.float32)
    s = jnp.conj(J.full_spectrum(jnp.fft.rfft(jnp.asarray(snippet), n=N), N))
    want = J.corr_single_query_packed(jnp.asarray(windows), s, 2003)
    s_t = T.query_spectrum(torch.from_numpy(snippet), N)
    got = T.corr_single_query_packed(torch.from_numpy(windows), s_t, 2003)
    assert got.shape == (B, 2003)
    _close(got, want)
    # the valid lags are the linear correlation
    ref = np.correlate(windows[1].astype(np.float64), snippet, "valid")
    np.testing.assert_allclose(got[1, : len(ref)].numpy(), ref, atol=2e-5)


TOL_LIB = 1e-5  # the library correlations: rfft/irfft of one length


def _close_lib(got, want):
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape
    assert np.max(np.abs(g - w)) <= TOL_LIB * np.max(np.abs(w))


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("use_conjugation", [True, False])
def test_correlate_matches(mode, scale, use_conjugation, rng):
    within = (rng.standard_normal((2, 3001)) * 0.1).astype(np.float32)
    sample = (rng.standard_normal(700) * 0.2).astype(np.float32)
    want = J.correlate(within, sample, mode, scale, use_conjugation)
    got = T.correlate(torch.from_numpy(within), torch.from_numpy(sample),
                      mode, scale, use_conjugation)
    _close_lib(got, want)
    if mode == "valid" and not scale:  # scipy's definition
        ref = np.correlate(within[0].astype(np.float64), sample, "valid")
        np.testing.assert_allclose(got[0].numpy(), ref, atol=2e-5)


def test_correlate_edge_cases_match():
    """A silent snippet scales to 0, not NaN; a window shorter than the
    snippet keeps one valid lag, as the reference's saturating length."""
    within = np.linspace(-1, 1, 50, dtype=np.float32)
    silent = np.zeros(10, np.float32)
    got = T.correlate(torch.from_numpy(within), torch.from_numpy(silent),
                      "valid", scale=True)
    assert torch.equal(got, torch.zeros(41))
    short = T.correlate(torch.from_numpy(within[:5]), torch.from_numpy(
        within[:9]), "valid")
    _close_lib(short, J.correlate(within[:5], within[:9], "valid"))
    with pytest.raises(ValueError, match="mode"):
        T.correlate(torch.from_numpy(within), torch.from_numpy(silent),
                    "circular")


@pytest.mark.parametrize("scale", [None, 0.37])
def test_correlate_valid_batch_matches(scale, rng):
    windows = (rng.standard_normal((3, 2, 2500)) * 0.1).astype(np.float32)
    sample = (rng.standard_normal(900) * 0.2).astype(np.float32)
    want = J.correlate_valid_batch(jnp.asarray(windows), jnp.asarray(sample),
                                   scale=scale)
    got = T.correlate_valid_batch(torch.from_numpy(windows),
                                  torch.from_numpy(sample), scale=scale)
    assert got.shape == (3, 2, 1601)
    _close_lib(got, want)
    with pytest.raises(ValueError, match="shorter"):
        T.correlate_valid_batch(torch.from_numpy(sample[:10]),
                                torch.from_numpy(sample))
