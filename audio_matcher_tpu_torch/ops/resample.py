"""Polyphase resampling on the device (port of ``ops/resample.py``).

scipy's ``resample_poly`` with its default Kaiser FIR: output sample j is
``Σ_n x[n] · h[half + j·down − n·up]``. The JAX package runs that as one
XLA convolution of the zero-stuffed signal; here it is written polyphase,
so the stuffed signal (``up`` times the input, ~15.6 GB of f32 for 600 s
at 48 → 44.1 kHz) never exists: the outputs ``up·k + p`` of phase ``p``
read the input from ``k·down`` on through that phase's ~⌈K/up⌉ taps, so
all phases together are one FP32 matmul of a strided view of the input,
``[rows, Wt] @ [Wt, up]``, whose ``[rows, up]`` result read row by row is
the output. Torch ops (no hand-written kernel, as JAX ran XLA): the
matmul runs in full FP32 whatever the caller's precision, and no
convolution (cuDNN's TF32 and FFT algorithms) is involved.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from .mxu_fft import fp32_matmul

_F32 = torch.float32
_ROW_BYTES = 64 << 20  # bounds the strided view's copy per matmul


@lru_cache(maxsize=32)
def _poly_filter(up: int, down: int) -> np.ndarray:
    """scipy.signal.resample_poly's default FIR (firwin Kaiser β=5.0,
    2·10·max(up,down) + 1 taps, cutoff at the tighter Nyquist), scaled by
    ``up`` to preserve amplitude; f32, the JAX package's taps."""
    from scipy.signal import firwin

    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = firwin(2 * half_len + 1, 1.0 / max_rate, window=("kaiser", 5.0))
    return (h * up).astype(np.float32)


@lru_cache(maxsize=32)
def _phase_matrix(up: int, down: int) -> tuple[np.ndarray, int]:
    """The polyphase weights [up, Wt] and the input offset ``s0`` of their
    first column: output ``up·k + p`` is ``Σ_i x[k·down + s0 + i] ·
    W[p, i]`` (x zero outside its range)."""
    h = _poly_filter(up, down)
    half = (len(h) - 1) // 2
    taps = -(-len(h) // up)  # the longest phase's tap count
    h_pad = np.zeros(taps * up, np.float32)
    h_pad[: len(h)] = h
    base = [(half + p * down) // up for p in range(up)]  # increasing in p
    s0 = base[0] - (taps - 1)
    W = np.zeros((up, base[-1] - s0 + 1), np.float32)
    for p in range(up):
        r = (half + p * down) % up
        m = np.arange(taps)
        # x[base_p + k·down − m] · h[r + m·up], at column base_p − m − s0
        W[p, base[p] - m - s0] = h_pad[r + m * up]
    return W, s0


def _quantize_int16(y: torch.Tensor) -> torch.Tensor:
    """f32 reference-scale PCM → the int16 staging wire, on y's device."""
    return torch.clamp(torch.round(y * 65535.0), -32768, 32767).to(
        torch.int16)


def resample_poly_device(samples, sr_from: int, sr_to: int,
                         wire_int16: bool = False,
                         device="cuda") -> torch.Tensor:
    """[..., T] samples (numpy or a tensor) → resampled on ``device`` (a
    tensor's own device when one is given): exactly scipy's
    ``resample_poly(x, up, down)`` length ``ceil(T·up/down)`` and
    centering, to float tolerance. Leading dimensions are a batch.
    ``wire_int16``: return the int16 staging wire (``round(y·65535)``,
    clipped) instead of f32, quantized on the device."""
    if isinstance(samples, torch.Tensor):
        x = samples.to(_F32)
    else:
        x = torch.from_numpy(np.asarray(samples, np.float32)).to(device)
    if sr_from == sr_to:
        return _quantize_int16(x) if wire_int16 else x
    g = math.gcd(int(sr_from), int(sr_to))
    up, down = int(sr_to) // g, int(sr_from) // g
    n = x.shape[-1]
    n_out = -(-n * up // down)
    W, s0 = _phase_matrix(up, down)
    wt = W.shape[1]
    rows = -(-n_out // up)
    # x_ext[i] = x[i + s0]: zeros before and past the signal
    right = max((rows - 1) * down + wt + s0 - n, 0)
    x_ext = torch.nn.functional.pad(x.reshape(-1, n), (-s0, right))
    w_t = torch.from_numpy(W.T.copy()).to(x.device)  # [Wt, up]
    out = torch.empty((x_ext.shape[0], rows, up), dtype=_F32, device=x.device)
    step = max(_ROW_BYTES // (4 * wt), 1)
    with fp32_matmul():
        for b in range(x_ext.shape[0]):
            view = x_ext[b].unfold(0, wt, down)  # [≥ rows, Wt], strided
            for r in range(0, rows, step):
                e = min(r + step, rows)
                torch.matmul(view[r:e], w_t, out=out[b, r:e])
    y = out.reshape(x.shape[:-1] + (rows * up,))[..., :n_out]
    return _quantize_int16(y) if wire_int16 else y
