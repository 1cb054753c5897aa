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

from ..ops.peaks import (
    Peak,
    find_peaks_scipy,
    find_peaks_slots,
    peaks_from_picks,
    pick_padded,
)
from ..ops.stft import fingerprint_scores, log_mel, mel_filterbank, n_frames_of
from ..parallel.step_graph import StepGraphs, run_step
from .matcher import device_ints, upload


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
    current CUDA device; ``"cpu"`` runs the same torch ops on the host).

    :meth:`match` stages the episode's f32 samples through a pinned buffer
    and runs one step on the device: the log-mel fingerprint, the NCC
    scores against the snippet's, their −inf pad to the picker's width
    and the device picker (``find_peaks_device``'s path, the JAX
    package's), of which only the picks are read back; past
    ``SCIPY_SLOTS`` candidate slots the step ends at the scores, which go
    to scipy on the host, as in the JAX package. ``graphs``: on a CUDA
    device, replay that step as a CUDA graph captured once per sample
    count (:attr:`step_graphs`, a
    :class:`~..parallel.step_graph.StepGraphs`), the counterpart of the
    JAX package's jitted steps; False runs it eagerly."""

    def __init__(self, snippet: np.ndarray, sr: int,
                 config: SpectrogramConfig | None = None, device="cuda",
                 graphs: bool = True):
        self.sr = int(sr)
        self.config = cfg = config or SpectrogramConfig()
        self.device = torch.device(device)
        self.step_graphs = StepGraphs() if graphs else None
        self._fb = torch.from_numpy(
            mel_filterbank(cfg.n_mels, cfg.n_fft, self.sr)).to(self.device)
        self.snippet_fp = log_mel(
            np.asarray(snippet, np.float32), self.sr, cfg.n_fft, cfg.hop,
            cfg.n_mels, fb=self._fb, device=self.device)
        # the tiled NCC's frame count on the device, made once
        self._widths = device_ints([self.snippet_fp.shape[0]], self.device)

    def _stage(self, samples: np.ndarray) -> torch.Tensor:
        """The f32 samples on the device: one copy from a pinned buffer on
        a CUDA device (:func:`~.matcher.upload`)."""
        x = torch.from_numpy(np.ascontiguousarray(samples, np.float32))
        if self.device.type == "cuda":
            x = x.pin_memory()
        return upload(x, self.device)

    def _picks(self, samples: np.ndarray):
        """The step's outputs for an episode on the device: (pos, h, prom),
        each [1, slots], or past ``SCIPY_SLOTS`` slots the [V] scores
        alone; None for an episode shorter than the snippet."""
        cfg = self.config
        V = (n_frames_of(len(samples), cfg.n_fft, cfg.hop)
             - self.snippet_fp.shape[0] + 1)
        if V < 1:
            return None
        distance = cfg.frame_distance(self.sr)
        slots = find_peaks_slots(V, distance)
        sr, n_fft, hop, n_mels = self.sr, cfg.n_fft, cfg.hop, cfg.n_mels

        def step(x, valid, fb, snippet_fp, widths):
            scores = fingerprint_scores(
                log_mel(x, sr, n_fft, hop, n_mels, fb=fb), snippet_fp,
                widths)
            if slots is None:
                return (scores,)
            return pick_padded(scores, valid, slots[1], distance, slots[0])

        return run_step(
            self.step_graphs, ("spectrogram_match", n_fft, hop, distance,
                               slots), step,
            (self._stage(samples), device_ints([V], self.device)),
            (self._fb, self.snippet_fp, self._widths))

    def match(self, samples: np.ndarray) -> list[Peak]:
        """→ peaks with ``position`` in samples (frame-accurate) and
        ``height`` ≥ ``min_score``; an episode shorter than the snippet
        gives no matches."""
        cfg = self.config
        out = self._picks(samples)
        if out is None:
            return []
        if len(out) == 1:
            peaks = find_peaks_scipy(out[0].cpu().numpy(),
                                     cfg.frame_distance(self.sr))
        else:
            peaks = peaks_from_picks(*(a[0].cpu().numpy() for a in out),
                                     0.0)
        return [Peak(p.position * cfg.hop, p.height, p.prominence)
                for p in peaks if p.height >= cfg.min_score]
