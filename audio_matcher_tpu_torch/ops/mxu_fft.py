"""Matmul FFT: Cooley-Tukey through DFT matrix products and twiddles
(port of ``ops/mxu_fft.py``, ``fft_impl="mxu"``).

The JAX package wrote this in plain ``jnp``, with no Pallas kernel, to put
the FFT's work on the TPU's matrix unit; the port keeps the same algorithm
on ``torch.matmul``, so this module carries no kernel. A transform of
length n = a1·a2·…·aL runs as L dense DFT products of radix ≤ 256, complex
values riding as a real "plane" axis of size 2 so that each stage is ONE
real product with the [2a, 2a] block matrix [[D_r, -D_i], [D_i, D_r]]. No
stage reorders its output: the spectrum stays digit-reversed, which the
correlation product never notices, and the inverse consumes it as it is.

Precision: every product runs in full FP32. A float32 product on a CUDA
device may otherwise take TF32 (``torch.set_float32_matmul_precision
("high")``), which keeps about three decimal digits and would break the
scores' 1.2e-5 tolerance, the reason the JAX package ran these products
at ``Precision.HIGHEST``; the module sets "highest" around its work and
restores the caller's setting.
"""

from __future__ import annotations

import contextlib
import math

import torch

from .wire import f32_scalar

_F32 = torch.float32


@contextlib.contextmanager
def fp32_matmul():
    """Full FP32 products inside, whatever the caller's precision."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def default_factors(n: int) -> tuple[int, ...]:
    """Factor n (a power of two) into balanced DFT radices ≤ 256: the
    fewest parts of ≤ 8 bits, as even as possible (2^22 → (256, 128,
    128))."""
    if n & (n - 1):
        raise ValueError(f"mxu fft requires a power of two, got {n}")
    e = n.bit_length() - 1
    if e == 0:
        raise ValueError("n must be ≥ 2")
    k = -(-e // 8)
    base, rem = divmod(e, k)
    parts = [base + 1] * rem + [base] * (k - rem)
    return tuple(1 << p for p in parts)


def _dft_mat(n: int, sign: int, device):
    """[n, n] DFT matrix W^{sign·jk} as (real, imag) f32; the exponent is
    reduced mod n as an exact integer before the f32 scale."""
    j = torch.arange(n, dtype=torch.int32, device=device)
    jk = (j[:, None] * j[None, :]) % n
    phase = (sign * 2.0 * math.pi / n) * jk.to(_F32)
    return torch.cos(phase), torch.sin(phase)


def _twiddle(a: int, m: int, sign: int, device):
    """[a, m] twiddle W_{a·m}^{sign·c·b} as (real, imag) f32; c·b < a·m
    ≤ 2^24 is exact in f32."""
    n = a * m
    c = torch.arange(a, dtype=_F32, device=device)[:, None]
    b = torch.arange(m, dtype=_F32, device=device)[None, :]
    phase = (sign * 2.0 * math.pi / n) * (c * b)
    return torch.cos(phase), torch.sin(phase)


def _block_mat(a: int, sign: int, inverse: bool, col_plane_major: bool,
               device):
    """[2a, 2a] real block matrix of the (inverse) DFT on plane-packed
    data. Rows are plane-major; columns plane-major (k·a + a_in) or, for
    the inverse's (c, 2) flatten, interleaved (a_in·2 + k)."""
    tr, ti = _dft_mat(a, -sign if inverse else sign, device)
    if col_plane_major:
        top = torch.cat([tr, -ti], dim=1)
        bot = torch.cat([ti, tr], dim=1)
    else:
        top = torch.stack([tr, -ti], dim=2).reshape(a, 2 * a)
        bot = torch.stack([ti, tr], dim=2).reshape(a, 2 * a)
    return torch.cat([top, bot], dim=0)


def _fft2p_rec(x, factors, sign):
    """x [..., 2, n] plane-major → scrambled [..., 2n]."""
    a = factors[0]
    n = x.shape[-1]
    m = n // a
    t2 = _block_mat(a, sign, False, True, x.device)
    y = torch.matmul(t2, x.reshape(*x.shape[:-2], 2 * a, m))
    if len(factors) == 1:
        return y.reshape(*y.shape[:-2], 2 * n)  # m == 1
    y = y.reshape(*y.shape[:-2], 2, a, m)
    wr, wi = _twiddle(a, m, sign, x.device)
    yr, yi = y[..., 0, :, :], y[..., 1, :, :]
    z = torch.stack([yr * wr - yi * wi, yr * wi + yi * wr], dim=-2)
    out = _fft2p_rec(z, factors[1:], sign)  # [..., c, 2m]: plane moved in
    return out.reshape(*out.shape[:-2], 2 * n)


def _ifft2p_rec(y, factors, sign):
    """Scrambled [..., 2n] → natural [..., 2, n] plane-major (unscaled)."""
    a = factors[0]
    n = y.shape[-1] // 2
    m = n // a
    if len(factors) == 1:
        t2 = _block_mat(a, sign, True, True, y.device)
        x = torch.matmul(y, t2.T)
        return x.reshape(*x.shape[:-1], 2, a)
    y = y.reshape(*y.shape[:-1], a, 2 * m)  # [..., c, 2m-scrambled]
    z = _ifft2p_rec(y, factors[1:], sign)  # [..., c, 2, m]
    wr, wi = _twiddle(a, m, -sign, y.device)
    zr, zi = z[..., 0, :], z[..., 1, :]
    z = torch.stack([zr * wr - zi * wi, zr * wi + zi * wr], dim=-2)
    zf = z.reshape(*z.shape[:-3], 2 * a, m)  # (c, 2) flattened, c-major
    t2 = _block_mat(a, sign, True, False, y.device)
    x = torch.matmul(t2, zf)
    return x.reshape(*x.shape[:-2], 2, n)  # rows are (o, a) o-major


def _cmatmul(tr, ti, xr, xi):
    """(tr + i·ti) @ (xr + i·xi): t [c, a], x [..., a, m] → [..., c, m];
    four real products."""
    return (torch.matmul(tr, xr) - torch.matmul(ti, xi),
            torch.matmul(tr, xi) + torch.matmul(ti, xr))


def _cfft_rec(xr, xi, factors, sign):
    """Natural-order four-step complex FFT along the last axis (length
    prod(factors)) of split (real, imag) f32 arrays."""
    a = factors[0]
    n = xr.shape[-1]
    m = n // a
    tr, ti = _dft_mat(a, sign, xr.device)
    # index = idx_a·m + idx_b → [..., a, m]
    xr = xr.reshape(*xr.shape[:-1], a, m)
    xi = xi.reshape(*xi.shape[:-1], a, m)
    yr, yi = _cmatmul(tr, ti, xr, xi)  # [..., c, m]
    if len(factors) == 1:
        return yr.reshape(*yr.shape[:-2], n), yi.reshape(*yi.shape[:-2], n)
    wr, wi = _twiddle(a, m, sign, xr.device)
    zr = yr * wr - yi * wi
    zi = yr * wi + yi * wr
    zr, zi = _cfft_rec(zr, zi, factors[1:], sign)  # [..., c, d]
    # k = c + a·d → put d before c, then flatten
    zr = zr.transpose(-1, -2).reshape(*zr.shape[:-2], n)
    zi = zi.transpose(-1, -2).reshape(*zi.shape[:-2], n)
    return zr, zi


def cfft_parts(xr, xi, inverse: bool = False,
               factors: tuple[int, ...] | None = None):
    """Complex FFT along the last axis of split (real, imag) f32 tensors,
    in natural order: forward as ``torch.fft.fft``, inverse as
    ``torch.fft.ifft`` (with the 1/n). Returns (real, imag)."""
    n = xr.shape[-1]
    factors = factors or default_factors(n)
    sign = 1 if inverse else -1
    with fp32_matmul():
        yr, yi = _cfft_rec(xr.to(_F32), xi.to(_F32), factors, sign)
    if inverse:
        s = f32_scalar(1.0 / n, yr.device)
        return yr * s, yi * s
    return yr, yi


def cfft(x, inverse: bool = False, factors: tuple[int, ...] | None = None):
    """:func:`cfft_parts` on a complex tensor: complex64 in and out."""
    yr, yi = cfft_parts(x.real.to(_F32), x.imag.to(_F32), inverse, factors)
    return torch.complex(yr, yi)


def cfft_scrambled_parts(xr, xi, factors: tuple[int, ...]):
    """Forward FFT along the last axis to digit-reversed order. The
    outputs are views [..., G, c_last] of the scrambled layout, meaningful
    only to :func:`icfft_scrambled_parts` and elementwise arithmetic."""
    x = torch.stack([xr.to(_F32), xi.to(_F32)], dim=-2)
    with fp32_matmul():
        out = _fft2p_rec(x, factors, -1)  # [..., 2n]
    v = out.reshape(*out.shape[:-1], -1, 2, factors[-1])
    return v[..., 0, :], v[..., 1, :]


def icfft_scrambled_parts(yr, yi, factors: tuple[int, ...]):
    """Inverse FFT from digit-reversed plane views to natural order,
    scaled by 1/n."""
    y = torch.stack([yr, yi], dim=-2)  # [..., G, 2, cL]
    n2 = y.shape[-3] * y.shape[-2] * y.shape[-1]
    with fp32_matmul():
        x = _ifft2p_rec(y.reshape(*y.shape[:-3], n2), factors, -1)
    s = f32_scalar(2.0 / n2, x.device)
    return x[..., 0, :] * s, x[..., 1, :] * s


def scrambled_spectra_parts(x, n: int, factors=None):
    """Digit-reversed full spectra of real rows ``x`` [..., ≤ n] (the
    query side of :func:`corr_slab_mxu`), as plane views
    [..., n // c_last, c_last]."""
    factors = factors or default_factors(n)
    x = x.to(_F32)
    if x.shape[-1] < n:
        x = torch.nn.functional.pad(x, (0, n - x.shape[-1]))
    return cfft_scrambled_parts(x, torch.zeros_like(x), factors)


def corr_slab_mxu(windows, s_scr_r, s_scr_i, valid_max: int, factors=None):
    """Every (window, query) valid correlation of windows [B, W ≤ n]
    against the digit-reversed query spectra [Q, G, c_last] of
    :func:`scrambled_spectra_parts`, the round trip staying digit-reversed.
    Consecutive (window, query) spectra pack in pairs into one complex
    inverse. Returns [B, Q, valid_max] f32."""
    B, W = windows.shape
    Q, G, c_last = s_scr_r.shape
    n = G * c_last
    factors = factors or default_factors(n)
    windows = windows.to(_F32)
    if W < n:
        windows = torch.nn.functional.pad(windows, (0, n - W))
    Xr, Xi = cfft_scrambled_parts(windows, torch.zeros_like(windows), factors)
    # C = X · conj(S) in the scrambled layout, flattened over (window,
    # query) and packed in pairs: V = C_2k + i·C_2k+1
    Cr = Xr[:, None] * s_scr_r[None] + Xi[:, None] * s_scr_i[None]
    Ci = Xi[:, None] * s_scr_r[None] - Xr[:, None] * s_scr_i[None]
    P = B * Q
    Cr, Ci = Cr.reshape(P, G, c_last), Ci.reshape(P, G, c_last)
    if P % 2:
        Cr = torch.nn.functional.pad(Cr, (0, 0, 0, 0, 0, 1))
        Ci = torch.nn.functional.pad(Ci, (0, 0, 0, 0, 0, 1))
    yr, yi = icfft_scrambled_parts(
        Cr[0::2] - Ci[1::2], Ci[0::2] + Cr[1::2], factors
    )  # [P/2, n]
    c = torch.stack([yr[..., :valid_max], yi[..., :valid_max]], dim=1)
    return c.reshape(-1, valid_max)[:P].reshape(B, Q, valid_max)
