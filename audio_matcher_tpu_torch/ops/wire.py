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


def _c(v: float, device) -> torch.Tensor:
    # a 0-d f32 tensor keeps every product in f32, as the JAX decode is
    return torch.tensor(v, dtype=_F32, device=device)


def dequant_to_f32(x: torch.Tensor) -> torch.Tensor:
    """Wire values (int16 / uint8 / float32) → f32 reference-scale PCM."""
    dev = x.device
    if x.dtype == torch.int16:
        return x.to(_F32) * _c(_I16_SCALE, dev)
    if x.dtype == torch.uint8:
        b = x.to(torch.int32).to(_F32) * _c(_U8_STEP, dev) - _c(1.0, dev)
        mag = torch.exp(b.abs() * _c(_LOG1P_MU, dev)) - _c(1.0, dev)
        u = torch.where(b >= 0, mag, -mag) * _c(_INV_MU, dev)
        return u * _c(_U8_OUT, dev)
    return x.to(_F32)
