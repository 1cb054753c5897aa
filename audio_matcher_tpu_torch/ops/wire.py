"""The staging wire grid's device decode (port of ``ops/wire.py``).

Encode lives host-side in ``models.matcher.quantize_wire``; this is its
inverse on tensors. The CUDA forward major pass (``csrc/fft_major.cu``)
decodes the same way in-register. int16 is value/65535 (the reference's
``(l+r)*0.5/65535`` PCM scale); μ-law (μ=255) expands with ``exp()-1``
through an int→float hop, exactly as the JAX package does, not with
``expm1``.
"""

from __future__ import annotations

import numpy as np
import torch

MU = 255.0

_F32 = torch.float32
_I16_SCALE = float(np.float32(1.0 / 65535.0))
_U8_STEP = float(np.float32(1.0 / 127.5))
_LOG1P_MU = float(np.float32(np.log1p(MU)))
_INV_MU = float(np.float32(1.0 / MU))
_U8_OUT = float(np.float32(32768.0 / 65535.0))


def silence_code(dtype: torch.dtype) -> int:
    """Wire value of silence for a wire dtype: μ-law's zero is code 128
    (code 0 decodes to about −0.5 full scale); int16 and f32 use 0."""
    return 128 if dtype == torch.uint8 else 0


_SCALARS: dict = {}


def f32_scalar(v: float, device) -> torch.Tensor:
    """``v`` as a 0-d f32 tensor on ``device``, made once per (value,
    device) and shared: a product with it stays in f32, as the JAX decode
    is, and a step that reuses it copies nothing from the host (a CUDA
    graph's capture refuses such a copy). Callers never write to it."""
    key = (float(v), torch.device(device))
    got = _SCALARS.get(key)
    if got is None:
        got = _SCALARS[key] = torch.tensor(v, dtype=_F32, device=device)
    return got


def dequant_to_f32(x: torch.Tensor) -> torch.Tensor:
    """Wire values (int16 / uint8 / float32) → f32 reference-scale PCM."""

    def c(v):
        return f32_scalar(v, x.device)

    if x.dtype == torch.int16:
        return x.to(_F32) * c(_I16_SCALE)
    if x.dtype == torch.uint8:
        b = x.to(torch.int32).to(_F32) * c(_U8_STEP) - c(1.0)
        mag = torch.exp(b.abs() * c(_LOG1P_MU)) - c(1.0)
        u = torch.where(b >= 0, mag, -mag) * c(_INV_MU)
        return u * c(_U8_OUT)
    return x.to(_F32)
