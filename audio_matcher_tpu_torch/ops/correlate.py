"""Snippet preparation and spectrum helpers (port of ``ops/correlate.py``).

Scores are ``corr · inv_autocorr`` with ``inv_autocorr = 1/Σ s²``, so a
perfect match scores ≈ 1.0. FFT lengths are powers of two ≥ n+m−1, which
keeps linear correlation through the zero-padded circular FFT exact.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def fft_length(min_len: int) -> int:
    """Smallest power of two ≥ min_len."""
    n = 1
    while n < min_len:
        n <<= 1
    return n


@dataclasses.dataclass(frozen=True)
class PreparedSnippet:
    """A query snippet and its inverse autocorrelation, kept host-side."""

    data: np.ndarray  # f32 [m]
    inv_autocorr: float  # 1 / Σ s²  (scores scale to ≈[-1, 1])

    @property
    def m(self) -> int:
        return int(self.data.shape[-1])


def prepare_snippet(sample: np.ndarray) -> PreparedSnippet:
    sample = np.asarray(sample, dtype=np.float32)
    ac = float(np.sum(sample.astype(np.float64) ** 2))
    inv = 1.0 / ac if ac != 0.0 else 0.0
    return PreparedSnippet(data=sample, inv_autocorr=inv)


def full_spectrum(s_half: torch.Tensor, n: int) -> torch.Tensor:
    """Hermitian-extend an rfft spectrum [..., n//2+1] to full length n
    (odd ``n`` has no real Nyquist bin: every bin but DC mirrors)."""
    mid = s_half[..., 1:-1] if n % 2 == 0 else s_half[..., 1:]
    return torch.cat([s_half, mid.flip(-1).conj()], dim=-1)
