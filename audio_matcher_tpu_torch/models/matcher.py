"""Host-side matcher seams of the port (``models/matcher.py``).

The config, the staging wire format, the slab policy, overlap-save
windowing and the cross-window dedup, with the reference semantics listed
in ``audio_matcher_tpu/models/matcher.py``:

  * window = chunk + overlap, hop = chunk; short tail windows keep their
    true length, windows shorter than the snippet yield nothing.
  * peak positions are rebased by chunk·chunk_index.
  * min_prominence = CLI value / 100; min_distance = whole seconds × sr.
  * prominence is window-local; the cross-window dedup drops a peak iff an
    immediate neighbour within ``distance`` is strictly more prominent.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..ops.peaks import Peak

DEFAULT_CHUNK_SECS = 60.0
DEFAULT_DISTANCE_SECS = 8 * 60.0
DEFAULT_PROMINENCE = 13.0


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """The JAX package's ``MatchConfig``, field for field. The defaults of
    ``fft_impl`` and ``peaks_impl`` name the one path the port runs (the
    two-factor FFT passes and the single-read peak reduction); the JAX
    package defaults to ``"xla"``/``"jnp"``, which the port refuses."""

    chunk_secs: float = DEFAULT_CHUNK_SECS
    distance_secs: float = DEFAULT_DISTANCE_SECS
    prominence: float = DEFAULT_PROMINENCE  # CLI units; /100 applied internally
    overlap_secs: float | None = None  # None → snippet duration
    slab: int = 8  # windows per slab (the preferred/maximum)
    slab_auto: bool = True  # shrink the slab when padding would waste >25%
    block: int = 2048  # prominence pyramid block size
    max_peaks_per_chunk: int = 64  # cap on distance-suppression rounds
    # staging wire: "float32" exact, "int16" the source's 16-bit grid,
    # "mulaw8" μ-law companded 8-bit (lossy, positions stay sample-exact)
    transfer_dtype: str = "float32"
    prominence_is_raw: bool = False
    fft_impl: str = "vpu"
    peaks_impl: str = "pallas"
    resample_impl: str = "auto"
    progress_slabs_per_dispatch: int = 4

    @property
    def min_prominence(self) -> float:
        if self.prominence_is_raw:
            return self.prominence
        return self.prominence / 100.0


_I16_SCALE = np.float32(65535.0)
WIRE_DTYPES = {
    "float32": np.float32,
    "int16": np.int16,
    "mulaw8": np.uint8,
}
TORCH_WIRE_DTYPES = {
    "float32": torch.float32,
    "int16": torch.int16,
    "mulaw8": torch.uint8,
}

_MU = 255.0


class _UlawTables:
    enc: np.ndarray | None = None  # uint16 VIEW of the int16 wire → uint8
    dec: np.ndarray | None = None  # uint8 → f32 (reference PCM scale)


def ulaw_tables() -> tuple[np.ndarray, np.ndarray]:
    """μ-law (μ=255) encode LUT (indexed by the uint16 view of the int16
    wire) and decode table, over the reference's ±0.5 full-scale range."""
    if _UlawTables.enc is None:
        w = np.arange(-32768, 32768, dtype=np.float64) / 32768.0
        f = np.sign(w) * np.log1p(_MU * np.abs(w)) / np.log1p(_MU)
        enc_by_value = np.clip(
            np.round((f + 1.0) * 127.5), 0, 255
        ).astype(np.uint8)
        _UlawTables.enc = np.roll(enc_by_value, -32768)
        b = np.arange(256, dtype=np.float64) / 127.5 - 1.0
        u = np.sign(b) * (np.expm1(np.abs(b) * np.log1p(_MU))) / _MU
        _UlawTables.dec = (u * 32768.0 / 65535.0).astype(np.float32)
    return _UlawTables.enc, _UlawTables.dec


def quantize_wire(samples: np.ndarray, transfer_dtype: str) -> np.ndarray:
    """Encode f32 reference-scale PCM (or int16 wire) to the staging dtype."""
    samples = np.asarray(samples)
    if transfer_dtype == "float32":
        if samples.dtype == np.int16:  # wire grid → reference PCM scale
            return samples.astype(np.float32) / _I16_SCALE
        return samples.astype(np.float32)
    if samples.dtype == np.int16:
        wire = samples
    else:
        wire = np.clip(
            np.round(samples.astype(np.float32) * _I16_SCALE), -32768, 32767
        ).astype(np.int16)
    if transfer_dtype == "int16":
        return wire
    if transfer_dtype == "mulaw8":
        enc, _ = ulaw_tables()
        return enc[np.ascontiguousarray(wire).view(np.uint16)]
    raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}")


def wire_silence(transfer_dtype: str) -> int:
    """Wire value of silence: 0, but μ-law's zero is code 128 (code 0
    decodes to about −0.5 full scale)."""
    return 128 if transfer_dtype == "mulaw8" else 0


def wire_buffer(shape, transfer_dtype: str) -> np.ndarray:
    """Host staging buffer pre-filled with the wire encoding of silence."""
    return np.full(
        shape, wire_silence(transfer_dtype), WIRE_DTYPES[transfer_dtype]
    )


def pad_wire_on_device(episode: torch.Tensor, target: int) -> torch.Tensor:
    """Pad a staged wire episode to ``target`` samples with silence
    (uint8 pads with 128, the μ-law code of 0), on its own device."""
    short = target - episode.shape[0]
    if short <= 0:
        return episode
    fill = 128 if episode.dtype == torch.uint8 else 0
    return torch.cat([episode, episode.new_full((short,), fill)])


def window_rows(window: int, chunk: int) -> int:
    """Chunk rows spanned by one overlap-save window."""
    return -(-window // chunk)


def pick_slab(
    n_windows: int, preferred: int, max_waste: float = 0.25
) -> int:
    """Windows per slab for an ``n_windows``-window episode: the preferred
    slab, unless padding to it wastes more than ``max_waste`` of the real
    windows; then the slab in [4, preferred) with the fewest padded windows
    (ties → the larger slab). Deterministic in ``n_windows``, so staging
    and scanning agree."""
    if n_windows <= preferred or preferred <= 4:
        return preferred
    best_s = preferred
    best_pad = -(-n_windows // preferred) * preferred
    if best_pad - n_windows <= max_waste * n_windows:
        return preferred
    for s in range(preferred - 1, 3, -1):
        p = -(-n_windows // s) * s
        if p < best_pad:
            best_s, best_pad = s, p
    return best_s


def divisor_slab(n_windows_pad: int, preferred: int) -> int:
    """The largest slab ≤ ``preferred`` that tiles the padded window count
    (for buffers staged under another slab policy)."""
    for s in range(min(preferred, n_windows_pad), 0, -1):
        if n_windows_pad % s == 0:
            return s
    return 1


def effective_slab(cfg, n_windows: int) -> int:
    """:func:`pick_slab` under the config's ``slab_auto`` policy."""
    if not getattr(cfg, "slab_auto", True):
        return cfg.slab
    return pick_slab(n_windows, cfg.slab)


def windows_from_episode(
    episode: torch.Tensor, base: int, slab: int, chunk: int, window: int
) -> torch.Tensor:
    """[slab, window] overlap-save windows starting at ``base·chunk``: a
    strided view of the staged episode (row stride ``chunk``), no copy.
    The episode must be padded to ``(base + slab + window_rows) · chunk``."""
    need = (base + slab - 1) * chunk + window
    if episode.shape[0] < need:
        raise ValueError(
            f"episode of {episode.shape[0]} samples is shorter than the "
            f"{need} the slab's windows span"
        )
    if episode.stride(0) != 1:
        raise ValueError("the episode must be contiguous")
    return episode.as_strided(
        (slab, window), (chunk, 1), episode.storage_offset() + base * chunk
    )


def overshadow_filter(
    peaks: Sequence[Peak], sr: int, distance_secs: float
) -> list[Peak]:
    """Drop peaks overshadowed by a strictly more prominent neighbour
    within ``distance``. Exact-position duplicates (an overlap-save seam
    sample seen by two windows, with bit-equal prominence) collapse first,
    keeping the most prominent."""
    best: dict[int, Peak] = {}
    for p in peaks:
        q = best.get(p.position)
        if q is None or p.prominence > q.prominence:
            best[p.position] = p
    peaks = sorted(best.values(), key=lambda p: p.position)
    out = []
    for i, p in enumerate(peaks):
        shadowed = False
        for j in (i - 1, i + 1):
            if 0 <= j < len(peaks):
                q = peaks[j]
                if (
                    abs(p.position - q.position) / sr < distance_secs
                    and q.prominence > p.prominence
                ):
                    shadowed = True
        if not shadowed:
            out.append(p)
    return out
