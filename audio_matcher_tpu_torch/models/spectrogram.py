"""Spectrogram-domain snippet matching, the noise-robust mode (port of
``models/spectrogram.py``; BASELINE config #4).

Episodes and snippets are reduced to log-mel STFT fingerprints
(``ops.stft``) and matched by zero-mean normalized cross-correlation over
frames: robust to codec artifacts, EQ and level changes and moderate
noise, where the PCM matcher's scores collapse; offsets are frame-accurate
(``hop`` samples). Torch ops on the matcher's device, no hand-written
kernel (the JAX package runs ``jnp``/XLA ops here too).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.peaks import Peak, find_peaks_device
from ..ops.stft import fingerprint_scores, log_mel, mel_filterbank


@dataclasses.dataclass(frozen=True)
class SpectrogramConfig:
    """The JAX package's ``SpectrogramConfig``, field for field."""

    n_fft: int = 1024
    hop: int = 256
    n_mels: int = 64
    distance_secs: float = 8 * 60.0  # the reference's default match spacing
    min_score: float = 0.4  # NCC threshold (scores in [-1, 1])
    # the batch scanner's staging wire (see MatchConfig.transfer_dtype):
    # NCC scores are scale-invariant; int16 keeps positions identical and
    # shifts scores by under 1 % (the log amplifies the 16-bit grid's noise
    # at quiet frames)
    transfer_dtype: str = "float32"
    resample_impl: str = "auto"  # cross-rate resampling in the sweep

    def frame_distance(self, sr: int) -> int:
        """The minimum match spacing in frames."""
        return max(int(self.distance_secs * sr / self.hop), 1)


def describe_spectrogram_path(device: torch.device,
                              where: str | None = None) -> str:
    """Which path a spectrogram scan runs, for the log (``where``, e.g. a
    mesh, in place of the device)."""
    return (f"{where or f'device {device}'}, spectrogram mode (log-mel "
            "NCC), torch ops (no hand-written kernel on this path)")


class SpectrogramMatcher:
    """Reusable per-snippet fingerprint matcher on ``device`` (default the
    current CUDA device; ``"cpu"`` runs the same torch ops on the host)."""

    def __init__(self, snippet: np.ndarray, sr: int,
                 config: SpectrogramConfig | None = None, device="cuda"):
        self.sr = int(sr)
        self.config = cfg = config or SpectrogramConfig()
        self.device = torch.device(device)
        self._fb = torch.from_numpy(
            mel_filterbank(cfg.n_mels, cfg.n_fft, self.sr)).to(self.device)
        self.snippet_fp = self._log_mel(snippet)

    def _log_mel(self, samples) -> torch.Tensor:
        cfg = self.config
        return log_mel(np.asarray(samples, np.float32), self.sr, cfg.n_fft,
                       cfg.hop, cfg.n_mels, fb=self._fb, device=self.device)

    def match(self, samples: np.ndarray) -> list[Peak]:
        """→ peaks with ``position`` in samples (frame-accurate) and
        ``height`` ≥ ``min_score``; an episode shorter than the snippet
        gives no matches."""
        cfg = self.config
        episode_fp = self._log_mel(samples)
        if episode_fp.shape[0] < self.snippet_fp.shape[0]:
            return []
        scores = fingerprint_scores(episode_fp, self.snippet_fp).cpu().numpy()
        peaks = find_peaks_device(
            scores, distance=cfg.frame_distance(self.sr), min_prominence=0.0,
            device=self.device,
        )
        return [Peak(p.position * cfg.hop, p.height, p.prominence)
                for p in peaks if p.height >= cfg.min_score]
