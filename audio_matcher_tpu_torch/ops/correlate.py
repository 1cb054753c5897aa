"""Snippet preparation, the library correlations (:func:`correlate`,
:func:`correlate_valid_batch`), spectrum helpers and the ``xla_packed``
correlation (port of ``ops/correlate.py``).

Scores are ``corr · inv_autocorr`` with ``inv_autocorr = 1/Σ s²``, so a
perfect match scores ≈ 1.0. FFT lengths are powers of two ≥ n+m−1, which
keeps linear correlation through the zero-padded circular FFT exact.

The ``xla_packed`` correlation packs two real correlations into each
complex transform: window pairs in the forward (``fft(w0 + i·w1)``), and
query pairs (``T = conj(S_2j) + i·conj(S_2j+1)``) or window pairs (one
query) in the inverse. The JAX package runs all of this module on plain
``jnp.fft``, outside any Pallas kernel, so the port runs it on
``torch.fft`` (cuFFT on a CUDA device) on the inputs' device, complex64
throughout. It holds no matrix product, so TF32 cannot reach it.
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


def _f32(x) -> torch.Tensor:
    """A tensor (kept on its device) or an array (on the CPU) as f32."""
    return torch.as_tensor(x).to(torch.float32)


def _corr_valid(windows, sample, fft_len: int, valid_len: int):
    x = torch.fft.rfft(windows, n=fft_len)
    s = torch.fft.rfft(sample, n=fft_len)
    return torch.fft.irfft(x * s.conj(), n=fft_len)[..., :valid_len]


def correlate_valid_batch(windows, sample, scale: float | None = None):
    """Valid-mode cross-correlation of windows [..., n] against one
    snippet [m]: output j = Σ_i windows[j+i]·sample[i], [..., n-m+1],
    times ``scale`` when given (``PreparedSnippet.inv_autocorr`` for
    normalized scores)."""
    windows, sample = _f32(windows), _f32(sample)
    n, m = windows.shape[-1], sample.shape[-1]
    if n < m:
        raise ValueError(f"window ({n}) shorter than sample ({m})")
    out = _corr_valid(windows, sample, fft_length(n + m - 1), n - m + 1)
    if scale is not None:
        out = out * torch.tensor(scale, dtype=out.dtype, device=out.device)
    return out


def _centered(arr: torch.Tensor, length: int) -> torch.Tensor:
    start = (arr.shape[-1] - length) // 2
    return arr[..., start : start + length]


def correlate(within, sample, mode: str = "valid", scale: bool = False,
              use_conjugation: bool = True) -> torch.Tensor:
    """scipy-compatible 1-D cross-correlation with the reference's modes:
    ``"full"`` (lags −(m−1)..n−1), ``"same"`` (centered n), ``"valid"``
    (centered n−m+1). ``scale`` divides by the snippet's energy (0 for a
    silent snippet). ``use_conjugation=False`` correlates as a convolution
    with the reversed snippet, the reference's alternative formulation."""
    within, sample = _f32(within), _f32(sample)
    n, m = within.shape[-1], sample.shape[-1]
    L = fft_length(n + m - 1)
    x = torch.fft.rfft(within, n=L)
    if use_conjugation:
        c = torch.fft.irfft(x * torch.fft.rfft(sample, n=L).conj(), n=L)
    else:
        s_rev = torch.fft.rfft(sample.flip(-1), n=L)
        # convolution with the reversed snippet = correlation shifted by m-1
        c = torch.roll(torch.fft.irfft(x * s_rev, n=L), -(m - 1), dims=-1)
    # circular index k holds lag k (k ≥ 0) and lag k-L (k > L-m): rotate so
    # the full output starts at lag -(m-1)
    full = torch.roll(c, m - 1, dims=-1)[..., : n + m - 1]
    if mode == "full":
        out = full
    elif mode == "same":
        out = _centered(full, n)
    elif mode == "valid":
        out = _centered(full, max(n - m, 0) + 1)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if scale:
        energy = (sample * sample).sum()
        out = torch.where(
            energy > 0, out / torch.where(energy > 0, energy, 1.0), 0.0
        )
    return out


def full_spectrum(s_half: torch.Tensor, n: int) -> torch.Tensor:
    """Hermitian-extend an rfft spectrum [..., n//2+1] to full length n
    (odd ``n`` has no real Nyquist bin: every bin but DC mirrors)."""
    mid = s_half[..., 1:-1] if n % 2 == 0 else s_half[..., 1:]
    return torch.cat([s_half, mid.flip(-1).conj()], dim=-1)


def query_spectrum(snippet: torch.Tensor, fft_len: int) -> torch.Tensor:
    """conj(full spectrum) of one query [m] → complex [fft_len], the
    single-query form :func:`corr_single_query_packed` takes."""
    S = torch.fft.rfft(snippet.to(torch.float32), n=fft_len)
    return full_spectrum(S, fft_len).conj().resolve_conj()


def packed_query_spectra(padded_snippets: torch.Tensor, fft_len: int):
    """[Q, m] query snippets → complex [⌈Q/2⌉, fft_len] query-pair
    spectra T[j] = conj(S_2j) + i·conj(S_2j+1) (an odd Q pairs its last
    query with zeros). One inverse transform of X·T[j] yields both real
    correlations of a window."""
    S = torch.fft.rfft(padded_snippets.to(torch.float32), n=fft_len)
    Sf = full_spectrum(S, fft_len)
    if Sf.shape[0] % 2:
        Sf = torch.cat([Sf, Sf.new_zeros((1, fft_len))])
    return Sf[0::2].conj() + 1j * Sf[1::2].conj()


def _pair_windows(windows: torch.Tensor) -> torch.Tensor:
    """[B, W] real windows → [⌈B/2⌉, W] complex w_2p + i·w_2p+1 (an odd
    B pairs its last window with zeros)."""
    if windows.shape[0] % 2:
        windows = torch.nn.functional.pad(windows, (0, 0, 0, 1))
    return torch.complex(windows[0::2], windows[1::2])


def _re_im_rows(v: torch.Tensor, valid_max: int, dim: int) -> torch.Tensor:
    """Real and imaginary parts of ``v[..., :valid_max]``, stacked at
    ``dim``."""
    v = v[..., :valid_max]
    return torch.stack([v.real, v.imag], dim=dim)


def corr_slab_xla_packed(
    windows: torch.Tensor,  # [B, W] f32
    t_spec: torch.Tensor,  # [Qh, n] complex — packed_query_spectra
    valid_max: int,
) -> torch.Tensor:
    """Every (window, query) correlation of a slab, with window pairs in
    the forward transforms (split by Hermitian symmetry) and query pairs
    in the inverse. Returns f32 [B, 2·Qh, valid_max]; the caller drops an
    odd Q's pad query."""
    n = t_spec.shape[-1]
    B = windows.shape[0]
    z = torch.fft.fft(_pair_windows(windows), n=n)  # [⌈B/2⌉, n]
    zrev = torch.roll(z.flip(-1), 1, dims=-1).conj()  # Z[(n - k) mod n]*
    x_even = 0.5 * (z + zrev)
    x_odd = -0.5j * (z - zrev)
    Xf = torch.stack([x_even, x_odd], dim=1).reshape(-1, n)[:B]
    v = torch.fft.ifft(Xf[:, None, :] * t_spec[None])  # [B, Qh, n]
    return _re_im_rows(v, valid_max, 2).reshape(B, -1, valid_max)


def corr_single_query_packed(
    windows: torch.Tensor,  # [B, W] f32
    s_full_conj: torch.Tensor,  # [n] complex — query_spectrum
    valid_max: int,
) -> torch.Tensor:
    """One query against a slab: window pairs pack into one complex
    transform each way. Returns f32 [B, valid_max]."""
    B = windows.shape[0]
    n = s_full_conj.shape[-1]
    v = torch.fft.ifft(
        torch.fft.fft(_pair_windows(windows), n=n) * s_full_conj[None]
    )
    return _re_im_rows(v, valid_max, 1).reshape(-1, valid_max)[:B]
