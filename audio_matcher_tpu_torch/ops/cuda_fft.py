"""Two-factor FFT in scrambled order, on hand-written CUDA passes.

Port of ``audio_matcher_tpu/ops/pallas_fft.py``: the wire paths (the
multi-query slab with query pairs packed into each inverse, the
single-query slab with window pairs packed into each transform), the same
two slabs from f32 windows (``corr_slab_vpu*``,
``corr_single_query_vpu*``, which the ``"vpu"`` correlation runs beside
``"jnp"`` peaks) and :func:`fft2_scrambled`, the transform each way. A
transform of length n = A·M (n ≤ 2^28), viewed [A, M] a-major, runs as a
DIF pass over the strided A axis with the cross twiddle folded in, then a
DIF pass over each contiguous M row. The spectrum stays in the scrambled
layout

    Y[r, q] = X[brev_A(r) + A · brev_M(q)]

end to end; the inverse consumes it directly (reversed DIF, conjugate
twiddles). Correlation never notices the order, and the query spectra are
permuted into it once (:func:`scrambled_query_spectra`).

Each pass has a wrapper and a plain PyTorch version beside it. The wrapper
runs the plain version for CPU tensors and launches its CUDA kernel
(``csrc/fft_major.cu``, ``csrc/fft_minor.cu``) for CUDA tensors; it never
falls back. The plain versions use ``torch.fft`` along the axis plus the
bit-reversal permutation, the masks and the twiddles, and are what the
kernels are checked against.
Forward transforms are unscaled; the inverse's 1/n is folded into the query
spectra.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch

from .. import _build
from . import fft_plan
from .wire import dequant_to_f32, silence_code

MIN_N = 1 << 14  # two 128-wide factors
MIN_FACTOR = 1 << fft_plan.MIN_LOG2  # 16 points a thread, 8+ threads a line
MAX_FACTOR = 1 << fft_plan.MAX_LOG2  # a line's 16 points a thread, 1024 threads
MAX_FFT_LEN = MAX_FACTOR * MAX_FACTOR  # 2^28
MAX_BLOCKS = (1 << 31) - 1  # a major pass counts its strips in an int
_F32 = torch.float32
_WIRE_CODES = {torch.uint8: 0, torch.int16: 1, torch.float32: 2}


@lru_cache(maxsize=8)
def _brev_host(n: int) -> np.ndarray:
    """Bit reversal of ``range(n)`` over log2(n) bits."""
    bits = n.bit_length() - 1
    i = np.arange(n, dtype=np.int64)
    out = np.zeros(n, np.int64)
    for b in range(bits):
        out |= ((i >> b) & 1) << (bits - 1 - b)
    return out


def split_factors(n: int) -> tuple[int, int]:
    """n = A·M with both factors powers of two, as square as possible."""
    if n & (n - 1):
        raise ValueError(f"two-factor fft needs a power of two, got {n}")
    e = n.bit_length() - 1
    a = e // 2
    A, M = 1 << a, 1 << (e - a)
    if A < 128 or M < 128:
        raise ValueError(f"n = {n} too small for the two-factor fft")
    return A, M


def scramble_index(n: int) -> np.ndarray:
    """Natural→scrambled gather index: scrambled[i] = natural[idx[i]]."""
    A, M = split_factors(n)
    sa, sm = _brev_host(A), _brev_host(M)
    return (sa[:, None] + A * sm[None, :]).reshape(n)


def round_planes_width(width: int, n: int) -> int:
    """Round a crop width up to a multiple of 8·M (or the full n): the crop
    the JAX package's planes path takes, kept so both scan the same
    columns."""
    _, M = split_factors(n)
    return min(-(-width // (8 * M)) * (8 * M), n)


def scrambled_query_spectra(
    padded_snippets: torch.Tensor, fft_len: int, pack: bool
):
    """Query spectra for the scrambled-FFT correlation, conjugated, scaled
    by 1/n and permuted into the scrambled layout, on the input's device.

    pack=True → query-pair spectra T[j] = (conj(S_2j) + i·conj(S_2j+1))/n;
    pack=False → conj(S)/n per query. Returns (Tr, Ti) f32 [rows, fft_len].
    """
    from .correlate import full_spectrum

    S = torch.fft.rfft(padded_snippets.to(_F32), n=fft_len)
    T = full_spectrum(S, fft_len).conj() * torch.tensor(
        1.0 / fft_len, dtype=_F32, device=S.device
    )
    if pack:
        if T.shape[0] % 2:
            T = torch.cat([T, T.new_zeros((1, fft_len))])
        T = T[0::2] + 1j * T[1::2]
    idx = torch.from_numpy(scramble_index(fft_len)).to(T.device)
    T = T[:, idx]
    return T.real.contiguous(), T.imag.contiguous()


# ---------------------------------------------------------------- helpers
def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {dev}")


def _log2(x: int, what: str) -> int:
    if x < 1 or x & (x - 1):
        raise ValueError(f"{what} must be a power of two, got {x}")
    return x.bit_length() - 1


def _planes(out, shape, like: torch.Tensor):
    """``out`` checked against ``shape``, or two new f32 planes."""
    if out is None:
        return (
            torch.empty(shape, dtype=_F32, device=like.device),
            torch.empty(shape, dtype=_F32, device=like.device),
        )
    for o in out:
        if (
            tuple(o.shape) != tuple(shape) or o.dtype != _F32
            or o.device != like.device or not o.is_contiguous()
        ):
            raise ValueError(f"out plane must be contiguous f32 {shape}")
    return out


def _f32_contig(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != _F32 or not t.is_contiguous():
            raise ValueError("expected contiguous float32 planes")


def _wire_rows(xw, eff: int, what: str) -> None:
    """Refuse wire windows the forward major kernels cannot read."""
    if xw.dtype not in _WIRE_CODES:
        raise ValueError(f"unsupported wire dtype {xw.dtype}")
    if xw.dim() != 2 or xw.stride(1) != 1 or xw.shape[1] < eff:
        raise ValueError(
            f"{what}: need [rows, >= {eff}] with unit column stride, got "
            f"{tuple(xw.shape)} strides {xw.stride()}"
        )


def _check_factors(A: int, M: int) -> None:
    if not (MIN_FACTOR <= A <= MAX_FACTOR and MIN_FACTOR <= M <= MAX_FACTOR):
        raise ValueError(
            f"the CUDA passes take factors from {MIN_FACTOR} to {MAX_FACTOR} "
            f"(fft_len up to {MAX_FFT_LEN}), got A = {A}, M = {M}"
        )


def _aligned16(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(
                "the passes move f32 planes 16 bytes at a time: they must "
                "be 16-byte aligned"
            )


def _check_blocks(P: int, log2A: int, log2M: int) -> None:
    """Raise if a major pass's strips (P·M/C, each a block's, or at A ≥
    8192 a cluster's: :func:`fft_plan.major_strips`) would pass
    MAX_BLOCKS, the kernels' int count of them."""
    if fft_plan.major_strips(P, log2A, log2M) > MAX_BLOCKS:
        raise ValueError(
            f"{P} planes of {1 << log2M} columns exceed {MAX_BLOCKS} strips"
        )


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_TWIDDLES: dict[tuple[int, int], torch.Tensor] = {}


def twiddle_table(L: int, device) -> torch.Tensor:
    """The passes' per-stage twiddle table for lines of L points, [L, 2]
    f32 (:func:`fft_plan.twiddle_table_plain`). On a CUDA device the
    ``twiddle_table`` kernel builds it once per (device, L) and it is kept;
    on the CPU it is the plain one."""
    device = torch.device(device)
    if device.type != "cuda":
        return fft_plan.twiddle_table_plain(L, device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    tw = _TWIDDLES.get((device.index, L))
    if tw is None:
        tw = torch.empty((L, 2), dtype=_F32, device=device)
        with torch.cuda.device(device):
            rc = _build.load().am_twiddles(
                tw.data_ptr(), _log2(L, "L"), _stream(tw))
        _build.check(rc, "am_twiddles")
        _TWIDDLES[(device.index, L)] = tw
    return tw


def _twiddles(L: int, like: torch.Tensor) -> int:
    """The twiddle table's pointer for lines of L points on like's device."""
    return twiddle_table(L, like.device).data_ptr()


def _cross_twiddle(A: int, M: int, n: int, sign: float, device):
    """exp(sign·2πi·brev_A(r)·c/n) as complex64 [A, M]; the exponent is an
    exact integer reduced mod n before the float64 scale."""
    br = torch.from_numpy(_brev_host(A)).to(device)
    k = (br[:, None] * torch.arange(M, device=device)[None, :]) % n
    ang = k.to(torch.float64) * (sign * 2.0 * math.pi / n)
    return torch.polar(torch.ones_like(ang), ang).to(torch.complex64)


def _brev_index(L: int, device) -> torch.Tensor:
    return torch.from_numpy(_brev_host(L)).to(device)


def _write(out, yr: torch.Tensor, yi: torch.Tensor):
    if out is None:
        return yr, yi
    out[0].copy_(yr)
    out[1].copy_(yi)
    return out


# ------------------------------------------ pass 1: forward major from wire
def _major_fwd_plain(xr, xi, A: int, n: int, out):
    """DIF over A in bit-reversed row order times the cross twiddle, of
    the f32 [P, <= n] planes ``xr`` (+ i·``xi``), zero-padded to n."""
    P = xr.shape[0]
    M = n // A

    def plane(x):
        return torch.nn.functional.pad(x, (0, n - x.shape[1])).reshape(P, A, M)

    x = plane(xr) if xi is None else torch.complex(plane(xr), plane(xi))
    X = torch.fft.fft(x, dim=1)
    X = X.index_select(1, _brev_index(A, X.device))
    X = X * _cross_twiddle(A, M, n, -1.0, X.device)
    return _write(out, X.real.contiguous(), X.imag.contiguous())


def fft_major_fwd_wire_plain(xw, A: int, n: int, w_len: int, out=None):
    """Plain version of :func:`fft_major_fwd_wire`."""
    x = dequant_to_f32(xw[:, : min(w_len, n)])
    return _major_fwd_plain(x, None, A, n, out)


def fft_major_fwd_wire(xw, A: int, n: int, w_len: int, out=None):
    """Forward major pass reading the staging wire format.

    ``xw``: [P, L] wire-dtype windows (uint8 μ-law, int16 or f32; rows may
    be strided, e.g. overlap-save views of one episode), L ≥ min(w_len, n).
    Elements at index ≥ ``w_len`` read as exact 0.0; the input is real.
    Returns (re, im) f32 [P, A, M]: the DIF over A in bit-reversed row order
    times the cross twiddle W_n^{brev_A(r)·c}.
    """
    if not on_cuda(xw):
        return fft_major_fwd_wire_plain(xw, A, n, w_len, out)
    log2A, M = _log2(A, "A"), n // A
    log2M = _log2(M, "M")
    _check_factors(A, M)
    P = xw.shape[0]
    eff = min(int(w_len), n)
    _wire_rows(xw, eff, "xw")
    _check_blocks(P, log2A, log2M)
    yr, yi = _planes(out, (P, A, M), xw)
    _aligned16(yr, yi)  # the TMA stores' tensor maps
    with torch.cuda.device(xw.device):
        rc = _build.load().am_major_fwd_wire(
            _WIRE_CODES[xw.dtype], xw.data_ptr(), xw.stride(0),
            yr.data_ptr(), yi.data_ptr(), _twiddles(A, xw), P, log2A, log2M,
            eff, _stream(xw),
        )
    _build.check(rc, "am_major_fwd_wire")
    _build.count_launch(fft_major_fwd_wire)
    return yr, yi


fft_major_fwd_wire.launches = 0


def fft_major_fwd_wire2_plain(x0, x1, A: int, n: int, w_len: int, out=None):
    """Plain version of :func:`fft_major_fwd_wire2`."""
    eff = min(int(w_len), n)
    short = x0.shape[0] - x1.shape[0]
    x1 = x1[:, :eff]
    if short:
        x1 = torch.cat([x1, x1.new_full((short, eff), silence_code(x1.dtype))])
    return _major_fwd_plain(
        dequant_to_f32(x0[:, :eff]), dequant_to_f32(x1), A, n, out
    )


def fft_major_fwd_wire2(x0, x1, A: int, n: int, w_len: int, out=None):
    """Forward major pass of ``fft(w0 + i·w1)`` from two wire windows.

    ``x0``: [P, L] wire-dtype windows for the real plane, ``x1``: [P1, L]
    (P1 ≤ P) of the same dtype for the imaginary plane; rows may be
    strided (the even and odd overlap-save windows of one episode). Rows
    of ``x0`` past P1 pair with wire silence (128 for μ-law, 0 otherwise),
    decoded like any sample: the pad window of an odd slab, never copied.
    Elements at index ≥ ``w_len`` read as exact 0.0 in both planes.
    Returns (re, im) f32 [P, A, M] as :func:`fft_major_fwd_wire` does.
    """
    if not on_cuda(x0, x1):
        return fft_major_fwd_wire2_plain(x0, x1, A, n, w_len, out)
    log2A, M = _log2(A, "A"), n // A
    log2M = _log2(M, "M")
    _check_factors(A, M)
    eff = min(int(w_len), n)
    _wire_rows(x0, eff, "x0")
    _wire_rows(x1, eff, "x1")
    P, P1 = x0.shape[0], x1.shape[0]
    if x1.dtype != x0.dtype or P1 > P:
        raise ValueError(
            f"x1 must be {x0.dtype} with at most {P} rows, got {x1.dtype} "
            f"{tuple(x1.shape)}"
        )
    _check_blocks(P, log2A, log2M)
    yr, yi = _planes(out, (P, A, M), x0)
    _aligned16(yr, yi)  # the TMA stores' tensor maps
    with torch.cuda.device(x0.device):
        rc = _build.load().am_major_fwd_wire2(
            _WIRE_CODES[x0.dtype], x0.data_ptr(), x0.stride(0),
            x1.data_ptr(), x1.stride(0), P1, yr.data_ptr(), yi.data_ptr(),
            _twiddles(A, x0), P, log2A, log2M, eff, _stream(x0),
        )
    _build.check(rc, "am_major_fwd_wire2")
    _build.count_launch(fft_major_fwd_wire2)
    return yr, yi


fft_major_fwd_wire2.launches = 0


# ------------------------------------- pass 2: minor, forward and inverse
def fft_minor_plain(xr, xi, M: int, out=None):
    """Plain version of :func:`fft_minor`."""
    Y = torch.fft.fft(torch.complex(xr, xi), dim=-1)
    Y = Y.index_select(-1, _brev_index(M, Y.device))
    return _write(out, Y.real.contiguous(), Y.imag.contiguous())


def ifft_minor_plain(xr, xi, M: int, out=None):
    """Plain version of :func:`ifft_minor`."""
    Y = torch.complex(xr, xi).index_select(-1, _brev_index(M, xr.device))
    y = torch.fft.ifft(Y, dim=-1, norm="forward")
    return _write(out, y.real.contiguous(), y.imag.contiguous())


def _minor_launch(entry: str, xr, xi, M: int, out):
    """Launch a minor pass over the rows of contiguous [..., M] planes."""
    log2M = _log2(M, "M")
    if xr.shape[-1] != M or xr.shape != xi.shape:
        raise ValueError(f"the minor pass takes two [..., M = {M}] planes")
    _check_factors(MIN_FACTOR, M)
    _f32_contig(xr, xi)
    yr, yi = _planes(out, tuple(xr.shape), xr)
    if {yr.data_ptr(), yi.data_ptr()} & {xr.data_ptr(), xi.data_ptr()}:
        raise ValueError("the minor pass does not run in place")
    _aligned16(xr, xi, yr, yi)
    with torch.cuda.device(xr.device):
        rc = getattr(_build.load(), entry)(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            _twiddles(M, xr), xr.numel() // M, log2M, _stream(xr),
        )
    _build.check(rc, entry)
    return yr, yi


def fft_minor(xr, xi, M: int, out=None):
    """Forward DIF pass over the contiguous M axis of [P, A, M] planes; the
    output row q holds frequency brev_M(q). ``out`` must not overlap the
    input (the kernel's pointers are restrict-qualified). At M = 8192 and
    16384 a row runs on a cluster of M/4096 blocks (:func:`minor_clusters`);
    where the card holds none the launch is refused and raises."""
    if not on_cuda(xr, xi):
        return fft_minor_plain(xr, xi, M, out)
    got = _minor_launch("am_minor_forward", xr, xi, M, out)
    _build.count_launch(fft_minor)
    return got


fft_minor.launches = 0


def ifft_minor(xr, xi, M: int, out=None):
    """Inverse mode of the minor pass (the JAX ``fft_minor`` with
    ``inverse=True``): input row q holds frequency brev_M(q), the output
    is in natural order, unscaled. ``out`` must not overlap the input."""
    if not on_cuda(xr, xi):
        return ifft_minor_plain(xr, xi, M, out)
    got = _minor_launch("am_minor_inverse", xr, xi, M, out)
    _build.count_launch(ifft_minor)
    return got


ifft_minor.launches = 0


def minor_clusters(kernel, M: int, device=None) -> int:
    """The clusters of M / 4096 blocks the card holds at once for the
    forward (:func:`fft_minor`) or inverse (:func:`ifft_minor`) minor pass
    at M = 8192 or 16384, ``cudaOccupancyMaxActiveClusters``; each takes
    one row. 0 means its launches are refused, and raise. CUDA only."""
    log2M = _log2(M, "M")
    if fft_plan.minor_cluster_log2(log2M) == 0:
        raise ValueError(f"M = {M} runs on blocks, not clusters")
    if kernel not in (fft_minor, ifft_minor):
        raise ValueError("the forward and inverse minor passes run on "
                         "clusters")
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError("cluster occupancy is a CUDA device's")
    got = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _build.load().am_minor_clusters(
            int(kernel is ifft_minor), log2M, ctypes.byref(got))
    _build.check(rc, "am_minor_clusters")
    return got.value


# ------------------------------- pass 3: product fused into inverse minor
def ifft_minor_product_plain(xr, xi, tr, ti, M: int, out=None):
    """Plain version of :func:`ifft_minor_product` (one window at a time,
    so the complex temporaries stay at [Qh, A, M])."""
    B, A, _ = xr.shape
    Qh = tr.shape[0]
    yr, yi = _planes(out, (B * Qh, A, M), xr)
    T = torch.complex(tr, ti)
    br = _brev_index(M, xr.device)
    for b in range(B):
        V = torch.complex(xr[b], xi[b])[None] * T
        y = torch.fft.ifft(V.index_select(-1, br), dim=-1, norm="forward")
        yr[b * Qh : (b + 1) * Qh] = y.real
        yi[b * Qh : (b + 1) * Qh] = y.imag
    return yr, yi


def ifft_minor_product(xr, xi, tr, ti, M: int, out=None):
    """[B] window spectra × [Qh] query-pair spectra → V = X·T, inverse DIF
    over M; returns [B·Qh, A, M] planes, row b·Qh + q. The product planes
    are never written."""
    if not on_cuda(xr, xi, tr, ti):
        return ifft_minor_product_plain(xr, xi, tr, ti, M, out)
    log2M = _log2(M, "M")
    B, A, M_ = xr.shape
    Qh = tr.shape[0]
    if (
        M_ != M or xi.shape != xr.shape
        or tuple(tr.shape) != (Qh, A, M) or ti.shape != tr.shape
    ):
        raise ValueError("product pass takes X [B, A, M] and T [Qh, A, M]")
    _check_factors(A, M)
    _f32_contig(xr, xi, tr, ti)
    yr, yi = _planes(out, (B * Qh, A, M), xr)
    _aligned16(xr, xi, tr, ti)
    with torch.cuda.device(xr.device):
        rc = _build.load().am_minor_product(
            xr.data_ptr(), xi.data_ptr(), tr.data_ptr(), ti.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), _twiddles(M, xr), B, A, Qh, log2M,
            _stream(xr),
        )
    _build.check(rc, "am_minor_product")
    _build.count_launch(ifft_minor_product)
    return yr, yi


ifft_minor_product.launches = 0


# ------------------------------------- pass 4: major, inverse and forward
_PLANES_PER_STEP = 32  # bounds the plain versions' complex temporaries


def fft_major_plain(xr, xi, A: int, n: int, a_crop: int, out=None):
    """Plain version of :func:`fft_major`, a few planes at a time."""
    P, _, M = xr.shape
    yr, yi = _planes(out, (P, a_crop, M), xr)
    tw = _cross_twiddle(A, M, n, 1.0, xr.device)
    br = _brev_index(A, xr.device)
    for p0 in range(0, P, _PLANES_PER_STEP):
        sl = slice(p0, p0 + _PLANES_PER_STEP)
        V = (torch.complex(xr[sl], xi[sl]) * tw).index_select(1, br)
        y = torch.fft.ifft(V, dim=1, norm="forward")[:, :a_crop]
        yr[sl] = y.real
        yi[sl] = y.imag
    return yr, yi


def _major_planes(xr, xi, A: int, n: int):
    """Check [P, A, M] f32 planes for a major pass; returns
    (P, log2A, log2M)."""
    M = n // A
    log2A, log2M = _log2(A, "A"), _log2(M, "M")
    P = xr.shape[0]
    if tuple(xr.shape) != (P, A, M) or xi.shape != xr.shape:
        raise ValueError(f"the major pass takes two [P, {A}, {M}] planes")
    _check_factors(A, M)
    _f32_contig(xr, xi)
    _aligned16(xr, xi)
    _check_blocks(P, log2A, log2M)
    return P, log2A, log2M


def fft_major(xr, xi, A: int, n: int, a_crop: int, out=None):
    """Inverse major pass (the JAX ``fft_major`` with ``inverse=True,
    cross=True``): conjugate cross twiddle, inverse DIF over A (scrambled
    rows in, natural rows out), and only the first ``a_crop`` rows
    written. Returns [P, a_crop, M] planes."""
    if not 0 < a_crop <= A:
        raise ValueError(f"a_crop must be in (0, {A}], got {a_crop}")
    if not on_cuda(xr, xi):
        return fft_major_plain(xr, xi, A, n, a_crop, out)
    P, log2A, log2M = _major_planes(xr, xi, A, n)
    yr, yi = _planes(out, (P, a_crop, n // A), xr)
    with torch.cuda.device(xr.device):
        rc = _build.load().am_major_inverse(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            _twiddles(A, xr), P, log2A, log2M, a_crop, _stream(xr),
        )
    _build.check(rc, "am_major_inverse")
    _build.count_launch(fft_major)
    return yr, yi


fft_major.launches = 0


def fft_major_forward_plain(xr, xi, A: int, n: int, out=None):
    """Plain version of :func:`fft_major_forward`."""
    P = xr.shape[0]
    return _major_fwd_plain(xr.reshape(P, n), xi.reshape(P, n), A, n, out)


def fft_major_forward(xr, xi, A: int, n: int, out=None):
    """Forward major pass of complex f32 planes (the JAX ``fft_major`` with
    ``inverse=False, cross=True``): DIF over A of each column of the
    [P, A, M] planes ``xr`` + i·``xi``, in bit-reversed row order, times the
    cross twiddle W_n^{brev_A(r)·c}. Returns [P, A, M] planes. ``out`` must
    not overlap the input."""
    if not on_cuda(xr, xi):
        return fft_major_forward_plain(xr, xi, A, n, out)
    P, log2A, log2M = _major_planes(xr, xi, A, n)
    yr, yi = _planes(out, tuple(xr.shape), xr)
    if {yr.data_ptr(), yi.data_ptr()} & {xr.data_ptr(), xi.data_ptr()}:
        raise ValueError("the major pass does not run in place")
    with torch.cuda.device(xr.device):
        rc = _build.load().am_major_forward(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            _twiddles(A, xr), P, log2A, log2M, _stream(xr),
        )
    _build.check(rc, "am_major_forward")
    _build.count_launch(fft_major_forward)
    return yr, yi


fft_major_forward.launches = 0

_CLUSTER_ENTRIES = {fft_major_fwd_wire: 0, fft_major_fwd_wire2: 1,
                    fft_major_forward: 2, fft_major: 3}


def major_clusters(kernel, A: int, dtype=torch.float32, device=None) -> int:
    """The clusters of A / 2048 blocks the card holds at once for a major
    pass at A = 8192 or 16384 (``kernel``: :func:`fft_major_fwd_wire`,
    :func:`fft_major_fwd_wire2` with wire ``dtype``,
    :func:`fft_major_forward` or :func:`fft_major`): the grid of its
    persistent walk, ``cudaOccupancyMaxActiveClusters`` at its shared
    memory. 0 means its launches are refused, and raise. CUDA only."""
    log2A = _log2(A, "A")
    if fft_plan.major_cluster_log2(log2A) == 0:
        raise ValueError(f"A = {A} runs on blocks, not clusters")
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError("cluster occupancy is a CUDA device's")
    got = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _build.load().am_major_clusters(
            _CLUSTER_ENTRIES[kernel], _WIRE_CODES[dtype], log2A,
            ctypes.byref(got))
    _build.check(rc, "am_major_clusters")
    return got.value


KERNELS = (
    fft_major_fwd_wire, fft_minor, ifft_minor_product, fft_major,
    fft_major_fwd_wire2, fft_major_forward, ifft_minor,
)


# ------------------------------------------------------------- the slab
def _work(work: dict | None, key: str, shape, like: torch.Tensor):
    """Planes of ``shape`` kept in ``work`` across slabs (None: fresh)."""
    if work is None:
        return None
    got = work.get(key)
    if got is None or tuple(got[0].shape) != tuple(shape):
        got = work[key] = _planes(None, shape, like)
    return got


def _check_width(width: int, n: int, M: int) -> None:
    if width % M or width > n or ((width // M) % 8 and width != n):
        raise ValueError(f"width {width} is not on the 8·M grid of n={n}")


def corr_single_query_vpu_planes_wire(
    windows, s_r, s_i, width: int, plain: bool = False,
    work: dict | None = None,
):
    """Single-query correlation planes of a slab of wire-dtype windows.

    Window pairs pack into one transform each way (``fft(w0 + i·w1)``;
    both correlations are real), so row p of the returned (yr, yi) holds
    window 2p's correlation in ``yr`` and window 2p+1's in ``yi``, cropped
    to ``width``: P = ⌈B/2⌉ rows. For odd B the last ``yi`` row pairs with
    wire silence; mask it downstream with ``valid_len`` 0. ``s_r``, ``s_i``:
    [1, n] from ``scrambled_query_spectra(pack=False)``. ``plain`` and
    ``work`` as in :func:`corr_slab_vpu_planes_wire`.
    """
    B, W = windows.shape
    n = s_r.shape[-1]
    A, M = split_factors(n)
    _check_width(width, n, M)
    P = (B + 1) // 2
    p1, p2, p3, p4 = (
        (fft_major_fwd_wire2_plain, fft_minor_plain,
         ifft_minor_product_plain, fft_major_plain)
        if plain else
        (fft_major_fwd_wire2, fft_minor, ifft_minor_product, fft_major)
    )
    X = p1(windows[0::2], windows[1::2], A, n, W,
           out=_work(work, "x", (P, A, M), s_r))
    X = p2(X[0], X[1], M, out=_work(work, "x2", (P, A, M), s_r))
    V = p3(
        X[0], X[1], s_r.view(1, A, M), s_i.view(1, A, M), M,
        out=_work(work, "v", (P, A, M), s_r),
    )
    a_crop = width // M
    yr, yi = p4(
        V[0], V[1], A, n, a_crop, out=_work(work, "y", (P, a_crop, M), s_r)
    )
    return yr.view(P, width), yi.view(P, width)


def corr_slab_vpu_planes_wire(
    windows, t_r, t_i, width: int, plain: bool = False,
    work: dict | None = None,
):
    """Pair-packed correlation planes of a slab of wire-dtype windows.

    Row ``b·Qh + j`` of the returned (yr, yi) holds the correlations of
    queries 2j and 2j+1 against window b, cropped to ``width`` columns
    (a multiple of 8·M, or n). Decode, zero pad and the zero imaginary
    plane happen inside the first pass; the product is fused into the
    inverse minor pass. ``plain=True`` runs every pass's plain version, on
    any device (the reference the kernels are held against). ``work``
    keeps the intermediate planes across calls.
    """
    B, W = windows.shape
    Qh, n = t_r.shape
    A, M = split_factors(n)
    _check_width(width, n, M)
    p1, p2, p3, p4 = (
        (fft_major_fwd_wire_plain, fft_minor_plain,
         ifft_minor_product_plain, fft_major_plain)
        if plain else
        (fft_major_fwd_wire, fft_minor, ifft_minor_product, fft_major)
    )
    X = p1(windows, A, n, W, out=_work(work, "x", (B, A, M), t_r))
    X = p2(X[0], X[1], M, out=_work(work, "x2", (B, A, M), t_r))
    V = p3(
        X[0], X[1], t_r.view(Qh, A, M), t_i.view(Qh, A, M), M,
        out=_work(work, "v", (B * Qh, A, M), t_r),
    )
    a_crop = width // M
    yr, yi = p4(
        V[0], V[1], A, n, a_crop,
        out=_work(work, "y", (B * Qh, a_crop, M), t_r),
    )
    return yr.view(B * Qh, width), yi.view(B * Qh, width)


# ------------------------------------------- the transform, f32 windows
def fft2_scrambled(xr, xi, n: int, inverse: bool = False, plain: bool = False,
                   work: dict | None = None):
    """[P, n] f32 planes → the scrambled spectrum (forward: major then
    minor pass) or, from a scrambled spectrum, the natural-order signal
    (``inverse``: inverse minor then inverse major pass, unscaled: fold
    1/n wherever convenient). ``plain`` and ``work`` as in
    :func:`corr_slab_vpu_planes_wire`."""
    A, M = split_factors(n)
    P = xr.shape[0]
    xr, xi = xr.reshape(P, A, M), xi.reshape(P, A, M)
    shape = (P, A, M)
    if not inverse:
        major, minor = ((fft_major_forward_plain, fft_minor_plain) if plain
                        else (fft_major_forward, fft_minor))
        X = major(xr, xi, A, n, out=_work(work, "x", shape, xr))
        X = minor(X[0], X[1], M, out=_work(work, "x2", shape, xr))
    else:
        minor, major = ((ifft_minor_plain, fft_major_plain) if plain
                        else (ifft_minor, fft_major))
        X = minor(xr, xi, M, out=_work(work, "x", shape, xr))
        X = major(X[0], X[1], A, n, A, out=_work(work, "x2", shape, xr))
    return X[0].reshape(P, n), X[1].reshape(P, n)


def _window_planes(even, odd, n: int, work: dict | None):
    """Contiguous zero-padded f32 planes [P, n] of real windows: ``even``
    [P, W] in the real plane, ``odd`` [P1 ≤ P, W] (or None) in the
    imaginary plane; rows past P1 are zero."""
    P, W = even.shape
    if work is None:
        xr = torch.empty((P, n), dtype=_F32, device=even.device)
        xi = torch.empty_like(xr)
    else:
        xr, xi = _work(work, "w", (P, n), even)
    xr[:, :W] = even
    xr[:, W:] = 0.0
    xi.zero_()
    if odd is not None:
        xi[: odd.shape[0], :W] = odd
    return xr, xi


def corr_slab_vpu_planes(
    windows, t_r, t_i, width: int, plain: bool = False,
    work: dict | None = None,
):
    """:func:`corr_slab_vpu_planes_wire` from f32 windows [B, W ≤ n]:
    zero-padded to n with a zero imaginary plane, then
    :func:`fft2_scrambled`. Row ``b·Qh + j`` of the returned (yr, yi) holds
    queries 2j and 2j+1 against window b, cropped to ``width`` (a multiple
    of 8·M, or n)."""
    B, _ = windows.shape
    Qh, n = t_r.shape
    A, M = split_factors(n)
    _check_width(width, n, M)
    p3, p4 = ((ifft_minor_product_plain, fft_major_plain) if plain
              else (ifft_minor_product, fft_major))
    xr, xi = _window_planes(windows, None, n, work)
    X = fft2_scrambled(xr, xi, n, plain=plain, work=work)
    V = p3(
        X[0].view(B, A, M), X[1].view(B, A, M),
        t_r.view(Qh, A, M), t_i.view(Qh, A, M), M,
        out=_work(work, "v", (B * Qh, A, M), t_r),
    )
    a_crop = width // M
    yr, yi = p4(
        V[0], V[1], A, n, a_crop,
        out=_work(work, "y", (B * Qh, a_crop, M), t_r),
    )
    return yr.view(B * Qh, width), yi.view(B * Qh, width)


def corr_slab_vpu(windows, t_r, t_i, valid_max: int, plain: bool = False,
                  work: dict | None = None):
    """Every (window, query) correlation of a slab of f32 windows, query
    pairs packed into each inverse: [B, 2·Qh, valid_max] (the caller drops
    an odd Q's pad query). The inverse major pass writes only the rows of
    ``valid_max`` rounded up to 8·M, which holds the same numbers the full
    transform would."""
    B = windows.shape[0]
    Qh, n = t_r.shape
    yr, yi = corr_slab_vpu_planes(
        windows, t_r, t_i, round_planes_width(valid_max, n), plain, work
    )
    c = torch.stack([yr[:, :valid_max], yi[:, :valid_max]], dim=1)
    return c.reshape(B, 2 * Qh, valid_max)


def corr_single_query_vpu_planes(
    windows, s_r, s_i, width: int, plain: bool = False,
    work: dict | None = None,
):
    """:func:`corr_single_query_vpu_planes_wire` from f32 windows [B, W]:
    window pairs pack as ``fft(w0 + i·w1)`` (an odd B pairs its last
    window with zeros), so row p of (yr, yi) holds windows 2p and 2p+1,
    cropped to ``width``; mask the odd-B pad row downstream."""
    B, _ = windows.shape
    n = s_r.shape[-1]
    A, M = split_factors(n)
    _check_width(width, n, M)
    P = (B + 1) // 2
    p3, p4 = ((ifft_minor_product_plain, fft_major_plain) if plain
              else (ifft_minor_product, fft_major))
    xr, xi = _window_planes(windows[0::2], windows[1::2], n, work)
    X = fft2_scrambled(xr, xi, n, plain=plain, work=work)
    V = p3(
        X[0].view(P, A, M), X[1].view(P, A, M),
        s_r.view(1, A, M), s_i.view(1, A, M), M,
        out=_work(work, "v", (P, A, M), s_r),
    )
    a_crop = width // M
    yr, yi = p4(
        V[0], V[1], A, n, a_crop, out=_work(work, "y", (P, a_crop, M), s_r)
    )
    return yr.view(P, width), yi.view(P, width)


def corr_single_query_vpu(windows, s_r, s_i, valid_max: int,
                          plain: bool = False, work: dict | None = None):
    """One query against a slab of f32 windows, window pairs in each
    transform → [B, valid_max]."""
    B = windows.shape[0]
    n = s_r.shape[-1]
    yr, yi = corr_single_query_vpu_planes(
        windows, s_r, s_i, round_planes_width(valid_max, n), plain, work
    )
    c = torch.stack([yr[:, :valid_max], yi[:, :valid_max]], dim=1)
    return c.reshape(-1, valid_max)[:B]
