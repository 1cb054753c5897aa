"""The FFT passes at the wide factors, 8192 and 16384 (fft_len 2^25-2^28),
on the CPU.

The kernels run only on a GPU (``tests/test_torch_gpu.py`` holds them
against these plain versions there); here the plain passes are held
against numpy's FFT in the scrambled order at the new factors with the
other factor at 128 (A = 16384, M = 128 and A = 128, M = 16384), the
kernels' way of forming the cross twiddle (a per-thread base times a
per-column table entry, ``root``'s split exponent above 2^24) against the
plain float64 one at 2^28; and the two-factor split, the scrambled
layout and the crop grid against the JAX package's at 2^25 - 2^28.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from audio_matcher_tpu.ops import pallas_fft as J  # noqa: E402

from audio_matcher_tpu_torch.ops import cuda_fft as F  # noqa: E402
from audio_matcher_tpu_torch.ops import fft_plan as P  # noqa: E402

TOL = 1e-5  # of the largest value: two f32 FFT algorithms
SHAPES = [(16384, 128), (128, 16384)]  # (A, M)


def _brev(L):
    return F._brev_host(L)


def _scrambled(Y, A, M):
    """numpy's natural-order spectrum [P, n] in the passes' layout [P, A,
    M]: Y[r, q] = X[brev_A(r) + A·brev_M(q)]."""
    idx = _brev(A)[:, None] + A * _brev(M)[None, :]
    return Y[:, idx]


def _complex(rng, P_, n):
    return (rng.standard_normal((P_, n))
            + 1j * rng.standard_normal((P_, n))).astype(np.complex64)


def _close(got, want):
    g = got[0].numpy() + 1j * got[1].numpy()
    assert g.shape == want.shape
    assert np.abs(g - want).max() <= TOL * np.abs(want).max()


def _planes(x, A, M):
    P_ = x.shape[0]
    return (torch.from_numpy(x.real.copy()).view(P_, A, M),
            torch.from_numpy(x.imag.copy()).view(P_, A, M))


@pytest.mark.parametrize("A,M", SHAPES)
def test_plain_forward_passes_give_the_scrambled_spectrum(A, M):
    """Forward major (complex planes, and μ-law wire zero-padded past
    w_len) then forward minor: numpy's FFT in the scrambled order."""
    n = A * M
    rng = np.random.default_rng(A)
    x = _complex(rng, 2, n)
    xr, xi = _planes(x, A, M)
    X = F.fft_major_forward_plain(xr, xi, A, n)
    _close(F.fft_minor_plain(X[0], X[1], M),
           _scrambled(np.fft.fft(x.astype(np.complex128)), A, M))
    codes = rng.integers(0, 256, (2, n), dtype=np.uint8)
    w_len = n - 3 * M - 5
    X = F.fft_major_fwd_wire_plain(torch.from_numpy(codes), A, n, w_len)
    pcm = F.dequant_to_f32(torch.from_numpy(codes[:, :w_len])).numpy()
    want = np.fft.fft(np.pad(pcm.astype(np.float64), ((0, 0), (0, n - w_len))))
    _close(F.fft_minor_plain(X[0], X[1], M), _scrambled(want, A, M))


@pytest.mark.parametrize("A,M", SHAPES)
def test_plain_inverse_and_product_passes_undo_it(A, M):
    """From a scrambled spectrum: inverse minor then inverse major give n
    times numpy's inverse; the product pass gives the inverse of X·T, and
    the cropped inverse major its first a_crop rows."""
    n = A * M
    rng = np.random.default_rng(M)
    y = _complex(rng, 2, n)
    t = _complex(rng, 1, n)
    Yr, Yi = _planes(_scrambled(y, A, M), A, M)
    Z = F.ifft_minor_plain(Yr, Yi, M)
    want = n * np.fft.ifft(y.astype(np.complex128))
    _close(F.fft_major_plain(Z[0], Z[1], A, n, A), want.reshape(2, A, M))
    Tr, Ti = _planes(_scrambled(t, A, M), A, M)
    V = F.ifft_minor_product_plain(Yr, Yi, Tr, Ti, M)
    a_crop = A // 2 + 8
    want = n * np.fft.ifft(y.astype(np.complex128) * t)
    _close(F.fft_major_plain(V[0], V[1], A, n, a_crop),
           want.reshape(2, A, M)[:, :a_crop])


def test_kernels_cross_twiddle_at_2_28_stays_within_a_few_ulp():
    """The kernels' cross twiddle W_n^{-brev_A(a)·c} at A = M = 16384 is
    base · ct[e] (``cross_base``, ``build_cross``, ``apply_cross``), each
    a ``root`` of an exact integer exponent, here mirrored by
    ``cross_root_plain``: within 8 ulp (of values in [0.5, 1)) of the
    float64 twiddle of the exact exponent (what the plain version,
    ``_cross_twiddle``, computes over the whole 2^28 plane), on rows and
    columns sampled over it, the last ones included."""
    log2A = log2M = 14
    A, M, n = 1 << log2A, 1 << log2M, 1 << 28
    rng = np.random.default_rng(28)
    a = np.concatenate([np.arange(16), A - 1 - np.arange(16),
                        rng.integers(0, A, 256)])
    c = np.concatenate([np.arange(16), M - 1 - np.arange(16),
                        rng.integers(0, M, 256)])
    u, r = a >> P.LOG2_PTS, a & (P.PTS - 1)
    e = _brev(P.PTS)[r]  # brev_A(a) = brev_A(u << 4) + brev_4(r)·A/16
    base = P.cross_root_plain(
        _brev(A)[u << P.LOG2_PTS][:, None] * c[None, :], 28, -1.0)
    ct = P.cross_root_plain(
        e[:, None] * (c[None, :] << (log2A - P.LOG2_PTS)), 28, -1.0)
    br, bi, tr, ti = base.real, base.imag, ct.real, ct.imag
    got = np.where(e[:, None] > 0, (br * tr - bi * ti) + 1j * (br * ti + bi * tr),
                   base)
    exact = np.exp(-2j * np.pi * ((_brev(A)[a][:, None] * c[None, :]) % n) / n)
    assert np.abs(got - exact).max() <= 8 * 2.0 ** -24



@pytest.mark.parametrize("log2n", [25, 26, 27, 28])
def test_wide_split_and_layout_match_jax(log2n):
    """The split the passes run at fft_len 2^25 - 2^28 is the JAX
    package's (4096 x 8192 up to 16384 x 16384), so the scrambled layout
    and the planes' crop grid are its too (the whole index at 2^25, its
    bit reversals above)."""
    n = 1 << log2n
    A, M = F.split_factors(n)
    assert (A, M) == J.split_factors(n) and A * M == n
    assert max(A, M) <= F.MAX_FACTOR and n <= F.MAX_FFT_LEN
    for L in (A, M):
        np.testing.assert_array_equal(F._brev_host(L), J._brev_host(L))
    for w in (1, 26_901_002, n // 3, n):
        assert F.round_planes_width(w, n) == J.round_planes_width(w, n)
    if log2n == 25:
        np.testing.assert_array_equal(F.scramble_index(n),
                                      J.scramble_index(n))
