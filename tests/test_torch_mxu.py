"""The port's matmul FFT (``fft_impl="mxu"``) against the JAX package's.

Both run the same digit-reversed four-step transform as dense f32 matrix
products (``jnp.einsum`` at ``Precision.HIGHEST`` on the CPU; FP32
``torch.matmul`` here), so they agree to the products' rounding: within
1e-5 of the largest reference value.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from audio_matcher_tpu.ops import mxu_fft as J  # noqa: E402

from audio_matcher_tpu_torch.ops import mxu_fft as T  # noqa: E402

TOL = 1e-5


def _close(got, want):
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        assert np.max(np.abs(g - w)) <= TOL * np.max(np.abs(w))


def test_default_factors_match():
    for e in range(1, 25):
        assert T.default_factors(1 << e) == J.default_factors(1 << e)
    with pytest.raises(ValueError):
        T.default_factors(3 << 10)


@pytest.mark.parametrize("n", [1 << 12, 1 << 15])
def test_scrambled_transforms_match(n, rng):
    factors = T.default_factors(n)
    xr = rng.standard_normal((2, n)).astype(np.float32)
    xi = rng.standard_normal((2, n)).astype(np.float32)
    want = J.cfft_scrambled_parts(jnp.asarray(xr), jnp.asarray(xi), factors)
    got = T.cfft_scrambled_parts(torch.from_numpy(xr), torch.from_numpy(xi),
                                 factors)
    _close(got, want)
    back = T.icfft_scrambled_parts(got[0], got[1], factors)
    _close(back, (xr, xi))  # the round trip, with the 1/n
    snippets = (rng.standard_normal((3, 1000)) * 0.2).astype(np.float32)
    _close(T.scrambled_spectra_parts(torch.from_numpy(snippets), n),
           J.scrambled_spectra_parts(jnp.asarray(snippets), n))


@pytest.mark.parametrize("B,Q", [(5, 3), (4, 1)])
def test_corr_slab_mxu_matches(B, Q, rng):
    n = 1 << 14
    windows = (rng.standard_normal((B, 11000)) * 0.1).astype(np.float32)
    snippets = (rng.standard_normal((Q, 3000)) * 0.2).astype(np.float32)
    s_j = J.scrambled_spectra_parts(jnp.asarray(snippets), n)
    want = J.corr_slab_mxu(jnp.asarray(windows), s_j[0], s_j[1], 8001)
    s_t = T.scrambled_spectra_parts(torch.from_numpy(snippets), n)
    got = T.corr_slab_mxu(torch.from_numpy(windows), s_t[0], s_t[1], 8001)
    assert got.shape == (B, Q, 8001)
    _close([got], [want])
    ref = np.correlate(windows[B - 1].astype(np.float64), snippets[Q - 1],
                       "valid")
    np.testing.assert_allclose(got[B - 1, Q - 1].numpy(), ref[:8001],
                               atol=2e-5 * np.abs(ref).max())


def test_matmuls_run_in_full_fp32(monkeypatch, rng):
    """A caller's TF32 setting does not reach the module's products, and
    is restored after them."""
    seen = []
    matmul = torch.matmul

    def spy(*args):
        seen.append(torch.get_float32_matmul_precision())
        return matmul(*args)

    monkeypatch.setattr(torch, "matmul", spy)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        x = torch.from_numpy(rng.standard_normal((2, 4096)).astype(np.float32))
        T.corr_slab_mxu(x, *T.scrambled_spectra_parts(x[:1, :500], 4096), 100)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert seen and set(seen) == {"highest"}


@pytest.mark.parametrize("inverse,n", [
    (False, 256), (False, 1024), (False, 4096), (False, 1 << 14),
    (False, 1 << 18), (True, 1024), (True, 1 << 16),
])
def test_cfft_matches_jax(inverse, n, rng):
    """The natural-order matmul FFT (``cfft``, ``cfft_parts``) on the JAX
    package's test inputs (tests/test_mxu_fft.py: 3 rows forward, 2
    inverse), forward and inverse (with the 1/n)."""
    rows = 2 if inverse else 3
    x = (rng.standard_normal((rows, n))
         + 1j * rng.standard_normal((rows, n))).astype(np.complex64)
    want = np.asarray(J.cfft(jnp.asarray(x), inverse=inverse))
    got = T.cfft(torch.from_numpy(x), inverse=inverse)
    assert got.dtype == torch.complex64
    _close((got.real, got.imag), (want.real, want.imag))
    parts = T.cfft_parts(torch.from_numpy(x.real.copy()),
                         torch.from_numpy(x.imag.copy()), inverse=inverse)
    jparts = J.cfft_parts(jnp.asarray(x.real), jnp.asarray(x.imag),
                          inverse=inverse)
    _close(parts, jparts)
    ref = np.fft.ifft(x) if inverse else np.fft.fft(x)
    assert np.abs(got.numpy() - ref).max() <= 2e-6 * np.abs(ref).max()
