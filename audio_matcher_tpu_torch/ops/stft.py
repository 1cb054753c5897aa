"""Log-mel STFT fingerprints and their normalized cross-correlation over
frames (port of ``ops/stft.py``; BASELINE config #4, spectrogram mode).

Torch ops on the tensors' device, no hand-written kernel: the JAX module
runs ``jnp.fft``, one matmul and cumsums. An episode is framed in blocks
of ``_FRAME_BLOCK`` frames (``Tensor.unfold``, a strided view), windowed
with the symmetric Hann window, transformed by ``torch.fft.rfft`` and
projected onto the mel basis in FP32, so only the [n_frames, n_mels]
fingerprint exists whole. The score is the zero-mean NCC of the
fingerprints over frame lags: the correlation by rFFT with a contraction
over the mel bins, the window-local statistics from two cumsum box
filters, which run in float64 here (the JAX package sums in f32: over a
65536-frame tile ``Σe² − (Σe)²/N`` cancels, and two f32 scans that round
differently can part by more than the score tolerance).
"""

from __future__ import annotations

import numpy as np
import torch

from .correlate import fft_length
from .mxu_fft import fp32_matmul

_F32 = torch.float32


def mel_filterbank(
    n_mels: int, n_fft: int, sr: int, fmin: float = 0.0, fmax: float | None = None
) -> np.ndarray:
    """HTK-scale (2595·log10(1+f/700)) triangular mel filterbank,
    area-normalized, [n_mels, n_fft//2+1] (the JAX package's, byte for
    byte; not librosa's Slaney default — both matcher sides share it)."""
    fmax = fmax if fmax is not None else sr / 2.0

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    freqs = mel_to_hz(mels)
    fft_freqs = np.linspace(0, sr / 2.0, n_fft // 2 + 1)
    fb = np.zeros((n_mels, n_fft // 2 + 1), np.float32)
    for i in range(n_mels):
        lo, cen, hi = freqs[i], freqs[i + 1], freqs[i + 2]
        up = (fft_freqs - lo) / max(cen - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - cen, 1e-9)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
        norm = fb[i].sum()
        if norm > 0:
            fb[i] /= norm
    return fb


_FRAME_BLOCK = 4096  # frames per STFT block: bounds the power array
_WINDOWS: dict = {}


def hann_window(n_fft: int, device) -> torch.Tensor:
    """The symmetric Hann window (``np.hanning``; ``torch.hann_window`` is
    periodic) as f32 on ``device``, made once per (n_fft, device): a scan
    step that reuses it copies nothing from the host."""
    key = (int(n_fft), torch.device(device))
    got = _WINDOWS.get(key)
    if got is None:
        got = _WINDOWS[key] = torch.from_numpy(
            np.hanning(n_fft).astype(np.float32)).to(device)
    return got


def stft_log_mel_core(x: torch.Tensor, fb: torch.Tensor, n_fft: int,
                      hop: int, n_frames: int) -> torch.Tensor:
    """[N] f32 samples → [n_frames, n_mels] ``log(power @ fb.T + 1e-8)``,
    block by block: each block of ``_FRAME_BLOCK`` frames is windowed,
    transformed and projected onto the mel basis at once, so the power
    array ([n_frames, n_fft//2+1], ~3.8 GB f32 for a 3 h 44.1 kHz
    episode) never exists whole. ``x`` is zero-padded to the last block's
    end."""
    n_blocks = -(-n_frames // _FRAME_BLOCK)
    needed = (n_blocks * _FRAME_BLOCK - 1) * hop + n_fft
    if x.shape[-1] < needed:
        x = torch.nn.functional.pad(x, (0, needed - x.shape[-1]))
    window = hann_window(n_fft, x.device)
    fb_t = fb.to(x.device, _F32).T  # [n_bins, n_mels]
    span_len = (_FRAME_BLOCK - 1) * hop + n_fft
    out = torch.empty((n_blocks * _FRAME_BLOCK, fb_t.shape[1]), dtype=_F32,
                      device=x.device)
    with fp32_matmul():
        for b in range(n_blocks):
            start = b * _FRAME_BLOCK * hop
            frames = x[start : start + span_len].unfold(0, n_fft, hop)
            z = torch.fft.rfft(frames * window, n=n_fft)
            power = z.real.square() + z.imag.square()
            rows = out[b * _FRAME_BLOCK : (b + 1) * _FRAME_BLOCK]
            torch.log(torch.matmul(power, fb_t) + 1e-8, out=rows)
    return out[:n_frames]


def n_frames_of(n: int, n_fft: int, hop: int) -> int:
    """Frames of an ``n``-sample signal (one frame below ``n_fft``: the
    signal is zero-padded to it)."""
    return 1 + (max(int(n), n_fft) - n_fft) // hop


def log_mel(samples, sr: int, n_fft: int = 1024, hop: int = 256,
            n_mels: int = 64, fb: torch.Tensor | None = None,
            device="cuda") -> torch.Tensor:
    """[T] samples (numpy or a tensor) → [n_frames, n_mels] log-mel
    fingerprint on ``device`` (a tensor's own device when one is
    given)."""
    if isinstance(samples, torch.Tensor):
        x = samples.to(_F32)
    else:
        x = torch.from_numpy(np.asarray(samples, np.float32)).to(device)
    if x.shape[-1] < n_fft:
        x = torch.nn.functional.pad(x, (0, n_fft - x.shape[-1]))
    if fb is None:
        fb = torch.from_numpy(mel_filterbank(n_mels, n_fft, sr))
    return stft_log_mel_core(x, fb, n_fft, hop,
                             n_frames_of(x.shape[-1], n_fft, hop))


def _box_sums(x: torch.Tensor, width, cols: int) -> torch.Tensor:
    """The first ``cols`` sliding-window sums of the last axis (cumsum box
    filter); ``width`` an int, or a [Q] tensor of widths giving [Q, cols]
    (``cols`` ≤ len − min(width) + 1; entries past a row's own range are
    not meaningful)."""
    csum = torch.nn.functional.pad(torch.cumsum(x, -1), (1, 0))
    if isinstance(width, int):
        return (csum[..., width:] - csum[..., :-width])[..., :cols]
    idx = torch.arange(cols, device=x.device)[None, :] + width[:, None]
    return csum[idx.clamp(max=csum.shape[-1] - 1)] - csum[:cols][None, :]


def _window_norms(seg_t: torch.Tensor, widths, cols: int) -> torch.Tensor:
    """sqrt of the window-local energy ``Σe² − (Σe)²/N`` of every
    ``width``-frame window over all mel bins, for the first ``cols`` lags
    of ``seg_t`` [M, T]; the box filters run in float64."""
    s1 = seg_t.sum(0, dtype=torch.float64)
    s2 = seg_t.square().sum(0, dtype=torch.float64)
    win_sum = _box_sums(s1, widths, cols)
    win_sq = _box_sums(s2, widths, cols)
    if isinstance(widths, int):
        patch = widths * seg_t.shape[0]
    else:
        patch = (widths * seg_t.shape[0]).to(torch.float64)[:, None]
    norm2 = (win_sq - win_sum * win_sum / patch).clamp(min=0.0)
    return norm2.sqrt().to(_F32)


def _zero_mean_spectrum(snippet_fp: torch.Tensor, fft_len: int):
    """Zero-meaned snippet fingerprint → (its rfft over time [M, F], its
    norm)."""
    s0 = snippet_fp - snippet_fp.mean()
    return torch.fft.rfft(s0.T, n=fft_len), s0.square().sum().sqrt()


def ncc_frames_core(episode_fp, snippet_fp, fft_len: int,
                    t_s: int) -> torch.Tensor:
    """Zero-mean normalized cross-correlation over the time axis.

    episode_fp: [T_e, M]; snippet_fp: [T_s, M]. The snippet is zero-meaned
    once, so the numerator needs no per-window episode mean; the
    denominator's window energy uses the window-local mean. Returns
    [T_e - T_s + 1] scores in [-1, 1]."""
    ex = episode_fp.T  # [M, T_e]
    S, snip_norm = _zero_mean_spectrum(snippet_fp, fft_len)
    E = torch.fft.rfft(ex, n=fft_len)
    valid = ex.shape[-1] - t_s + 1
    corr = torch.fft.irfft((E * S.conj()).sum(0), n=fft_len)[:valid]
    return corr / (_window_norms(ex, t_s, valid) * snip_norm + 1e-8)


# overlap-save tiling threshold for the frame-domain NCC: above this the
# whole-episode FFT's [M, fft_len] complex intermediates would dominate
NCC_TILE = 1 << 16


def ncc_frames_tiled_core(episode_fp, snippet_fp, t_s: int,
                          tile: int = NCC_TILE,
                          widths: torch.Tensor | None = None) -> torch.Tensor:
    """Overlap-save ZNCC over frames: ``tile``-frame chunks with a
    ``t_s - 1`` halo, so one [M, tile + t_s - 1] spectrum exists at a time
    however long the episode is. The same scores as the single-shot path
    (correlation is linear; the window statistics are window-local).
    ``widths``: ``[t_s]`` int64 on the episode's device, where the caller
    keeps one (see :func:`ncc_frames_multi_core`)."""
    t_e = episode_fp.shape[0]
    valid_total = t_e - t_s + 1
    if valid_total <= tile:
        return ncc_frames_core(episode_fp, snippet_fp,
                               fft_length(t_e + t_s - 1), t_s)
    return ncc_frames_multi_core(episode_fp, snippet_fp[None], (t_s,),
                                 tile, widths)[0]


def ncc_frames_multi_core(episode_fp, snip_fps, t_ss: tuple,
                          tile: int = NCC_TILE,
                          widths: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-query overlap-save ZNCC sharing the episode tile spectra.

    episode_fp [T_e, M]; snip_fps [Q, t_max, M], zero-padded beyond each
    query's ``t_ss[q]`` frames. Each tile's M forward transforms (the
    dominant cost) are computed once for all queries; per query only the
    product, one inverse transform and the box filters remain. Returns
    [Q, T_e - min(t_ss) + 1]; entries at lags ≥ T_e - t_ss[q] + 1 are
    garbage — mask them with each query's valid length. ``widths``:
    ``t_ss`` as an int64 tensor on the episode's device, where the caller
    keeps one (else it is copied from the host here)."""
    t_e, n_mels = episode_fp.shape
    dev = episode_fp.device
    t_max = max(t_ss)
    valid_total = max(t_e - min(t_ss) + 1, 1)
    tile = min(tile, valid_total)
    win = tile + t_max - 1
    L = fft_length(win + t_max - 1)
    n_tiles = -(-valid_total // tile)
    pad_to = (n_tiles - 1) * tile + win
    ep = torch.nn.functional.pad(episode_fp, (0, 0, 0, max(pad_to - t_e, 0)))
    spectra, norms = zip(*(_zero_mean_spectrum(snip_fps[q, :t_s], L)
                           for q, t_s in enumerate(t_ss)))
    # [Q, M, F], shared by the tiles; conjugated once (``conj()`` is a
    # view that every product would conjugate again)
    S_conj = torch.stack(spectra).conj_physical()
    snip_norm = torch.stack(norms)[:, None]
    if widths is None:
        widths = torch.tensor(t_ss, device=dev)
    out = torch.empty((len(t_ss), n_tiles * tile), dtype=_F32, device=dev)
    for k in range(n_tiles):
        seg_t = ep[k * tile : k * tile + win].T  # [M, win]
        E = torch.fft.rfft(seg_t, n=L)  # one set for all queries
        corr = torch.fft.irfft((E[None] * S_conj).sum(1), n=L)[:, :tile]
        out[:, k * tile : (k + 1) * tile] = corr / (
            _window_norms(seg_t, widths, tile) * snip_norm + 1e-8)
    return out[:, :valid_total]


def fingerprint_scores(episode_fp, snippet_fp,
                       widths: torch.Tensor | None = None) -> torch.Tensor:
    """Zero-mean NCC scores per frame lag (window-local statistics); long
    episodes take the overlap-save tiled path (``widths``: see
    :func:`ncc_frames_tiled_core`)."""
    t_e, t_s = episode_fp.shape[0], snippet_fp.shape[0]
    if t_e < t_s:
        raise ValueError("episode shorter than snippet")
    if t_e - t_s + 1 > NCC_TILE:
        return ncc_frames_tiled_core(episode_fp, snippet_fp, t_s, NCC_TILE,
                                     widths)
    return ncc_frames_core(episode_fp, snippet_fp,
                           fft_length(t_e + t_s - 1), t_s)
