"""The snippet matcher and the host-side matcher seams of the port
(``models/matcher.py``).

:class:`SnippetMatcher` scans episodes against one query snippet
(BASELINE config #2): the episode is staged once in its wire dtype,
overlap-save windows are strided views of it, and each slab of windows
runs the single-query correlation and the peak picking on the episode's
device (by default the current CUDA device), in a Python loop over slabs.
Every ``fft_impl`` of the JAX package runs, with either ``peaks_impl``:

  * ``"vpu"`` + ``"pallas"`` (the default, the fused path): the wire
    windows go straight into the two-factor FFT kernels, window pairs
    share each transform, and the pair-packed planes go to the single-read
    peak reduction;
  * every other pair dequantizes the episode once on the device, computes
    the [B, V] correlation (``"vpu"``: the two-factor FFT kernels from f32
    windows; ``"xla_packed"``/``"xla"``: ``torch.fft``; ``"mxu"``: the
    matmul FFT) and picks peaks with the dense single-read picker
    (``"pallas"``) or the multi-pass one (``"jnp"``).

Beside it: the config, the staging wire format, the slab policy,
overlap-save windowing and the cross-window dedup, with the reference
semantics listed in ``audio_matcher_tpu/models/matcher.py``:

  * window = chunk + overlap, hop = chunk; short tail windows keep their
    true length, windows shorter than the snippet yield nothing.
  * peak positions are rebased by chunk·chunk_index.
  * min_prominence = CLI value / 100; min_distance = whole seconds × sr.
  * prominence is window-local; the cross-window dedup drops a peak iff an
    immediate neighbour within ``distance`` is strictly more prominent.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Sequence

import numpy as np
import torch

from ..ops.correlate import (
    PreparedSnippet,
    corr_single_query_packed,
    fft_length,
    prepare_snippet,
    query_spectrum,
)
from ..ops.cuda_fft import (
    MAX_FFT_LEN,
    MIN_N,
    corr_single_query_vpu,
    corr_single_query_vpu_planes_wire,
    round_planes_width,
    scrambled_query_spectra,
)
from ..ops.mxu_fft import corr_slab_mxu, scrambled_spectra_parts
from ..ops.peaks import (
    Peak,
    peaks_crop_width,
    pick_peaks_dispatch,
    pick_peaks_packed,
)
from ..ops.wire import dequant_to_f32, silence_code
from ..parallel.step_graph import StepGraphs, releasing, run_step
from ..utils import spans

log = logging.getLogger("audio_matcher_torch.matcher")

DEFAULT_CHUNK_SECS = 60.0
DEFAULT_DISTANCE_SECS = 8 * 60.0
DEFAULT_PROMINENCE = 13.0


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """The JAX package's ``MatchConfig``, field for field. The defaults of
    ``fft_impl`` and ``peaks_impl`` name the port's main path (the
    two-factor FFT kernels and the single-read peak reduction, fused),
    where the JAX package defaults to ``"xla"``/``"jnp"``: on the GPU the
    kernel path is the one this port is built and measured for, and the
    other values select the JAX package's other branches, which the port
    runs too (``fft_impl`` in ``FFT_IMPLS``, ``peaks_impl`` in
    ``PEAKS_IMPLS``)."""

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


FFT_IMPLS = ("vpu", "xla_packed", "xla", "mxu")
PEAKS_IMPLS = ("pallas", "jnp")


def resolve_fft_impl(cfg: MatchConfig, fft_len: int) -> str:
    """The correlation path a matcher runs for ``cfg`` at ``fft_len``:
    ``cfg.fft_impl``, except that ``"vpu"`` falls back to ``"xla_packed"``
    below ``MIN_N``, where two 128-wide factors do not fit, as in the JAX
    package. Unknown names raise :class:`ValueError`."""
    if cfg.fft_impl not in FFT_IMPLS:
        raise ValueError(
            f"fft_impl={cfg.fft_impl!r}: expected one of {FFT_IMPLS}"
        )
    if cfg.peaks_impl not in PEAKS_IMPLS:
        raise ValueError(
            f"peaks_impl={cfg.peaks_impl!r}: expected one of {PEAKS_IMPLS}"
        )
    if cfg.fft_impl == "vpu" and fft_len < MIN_N:
        return "xla_packed"
    return cfg.fft_impl


def check_fft_len(fft_impl: str, fft_len: int, device: torch.device):
    """Refuse an ``fft_len`` the CUDA FFT passes cannot run for a ``"vpu"``
    matcher on a CUDA device: above ``MAX_FFT_LEN`` = 2^28 a factor of the
    two-factor split passes 16384, and a line of 32768 points would need
    2048 threads of 16 points where a block holds 1024 (one padded slab's
    planes would pass 34 GB besides)."""
    if fft_impl == "vpu" and device.type == "cuda" and fft_len > MAX_FFT_LEN:
        raise ValueError(
            f"fft_len {fft_len} exceeds {MAX_FFT_LEN} (2^28), the largest "
            "the CUDA FFT passes run (factors up to 16384: a line of 16 "
            "points a thread in a block of at most 1024 threads); shorten "
            "chunk_secs or the snippet"
        )


def is_fused(fft_impl: str, peaks_impl: str) -> bool:
    """The fused path: wire windows into the FFT kernels, pair-packed
    planes into the single-read peak reduction."""
    return fft_impl == "vpu" and peaks_impl == "pallas"


def describe_path(device: torch.device, fft_impl: str, peaks_impl: str,
                  plain: bool, where: str | None = None) -> str:
    """Which path a scan runs, for the log: the device (``where``, e.g. a
    mesh, in its place), the correlation and peak paths, and whether the
    kernels or their plain versions run (CPU tensors always take the plain
    versions)."""
    if plain or device.type != "cuda":
        kernels = "the kernels' plain PyTorch versions"
    elif fft_impl == "vpu" or peaks_impl == "pallas":
        kernels = "the hand-written CUDA kernels"
    else:
        kernels = "torch ops (no hand-written kernel on this path)"
    where = where or f"device {device}"
    return (f"{where}, fft_impl {fft_impl}, peaks_impl {peaks_impl}, "
            f"{kernels}")


def correlation_crop(
    valid_max: int, block: int, fft_len: int, fft_impl: str,
    peaks_impl: str,
) -> int:
    """Columns of correlation a slab computes: the picker's crop
    (``peaks_crop_width``), on the planes kernels' 8·M grid for the fused
    path."""
    crop = min(peaks_crop_width(valid_max, block, peaks_impl), fft_len)
    if is_fused(fft_impl, peaks_impl):
        return round_planes_width(crop, fft_len)
    return crop


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
    return silence_code(TORCH_WIRE_DTYPES[transfer_dtype])


def wire_buffer(shape, transfer_dtype: str) -> np.ndarray:
    """Host staging buffer pre-filled with the wire encoding of silence."""
    return np.full(
        shape, wire_silence(transfer_dtype), WIRE_DTYPES[transfer_dtype]
    )


def _wire_row(ep, i: int, n_pad: int, transfer: str) -> np.ndarray:
    """Episode ``i`` in the wire dtype: rows already in it are copied,
    others quantize here."""
    ep = np.asarray(ep)
    if len(ep) > n_pad:
        raise ValueError(f"episode {i} is longer than the staged width")
    return ep if ep.dtype == WIRE_DTYPES[transfer] else quantize_wire(
        ep, transfer)


def fill_wire_rows(episodes, n_pad: int, transfer: str, rows: int,
                   pinned: bool = False) -> torch.Tensor:
    """Pack episodes into a fresh [rows, n_pad] wire-dtype host tensor
    (page-locked when ``pinned``, so that its upload is one DMA): each row
    is its episode, then silence to ``n_pad``; rows past the episodes are
    silence. Only what no episode covers is silenced, row by row, and a
    pinned tensor comes from PyTorch's caching host allocator, which hands
    a freed block out again only after the copies that read it completed.
    Spans ``stage.alloc`` (the buffer) and ``stage.fill`` (the rows)."""
    with spans.span("stage.alloc"):
        buf = torch.empty((rows, n_pad), dtype=TORCH_WIRE_DTYPES[transfer],
                          pin_memory=pinned)
    with spans.span("stage.fill"):
        out = buf.numpy()
        silence = wire_silence(transfer)
        for i in range(rows):
            n = 0
            if i < len(episodes):
                wire = _wire_row(episodes[i], i, n_pad, transfer)
                n = len(wire)
                out[i, :n] = wire
            out[i, n:] = silence
    return buf


class _SideStreams:
    by_key: dict = {}


def side_stream(device: torch.device, role: str = "upload"):
    """The side stream of ``device`` that uploads staged groups
    (``"upload"``) or reads scan results back (``"readback"``)."""
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    stream = _SideStreams.by_key.get((index, role))
    if stream is None:
        stream = _SideStreams.by_key[index, role] = torch.cuda.Stream(index)
    return stream


def read_back(tensors, ready=None) -> list[np.ndarray]:
    """Device tensors → numpy arrays. With ``ready``, a CUDA event recorded
    behind the work that wrote them, the copy runs on the readback stream
    after that event only, so it does not wait for work queued later on
    the current stream (the next group's scan)."""
    if ready is None:
        return [a.cpu().numpy() for a in tensors]
    stream = side_stream(tensors[0].device, "readback")
    with torch.cuda.stream(stream):
        stream.wait_event(ready)
        host = [a.to("cpu", non_blocking=True) for a in tensors]
    with spans.span("collect.wait"):
        stream.synchronize()
    return [h.numpy() for h in host]


def upload(host: torch.Tensor, device: torch.device):
    """Copy a staged host tensor to ``device``.

    On a CUDA device the copy runs on :func:`side_stream` from the pinned
    buffer without blocking the host, so it overlaps the scan already
    queued on the current stream. The current stream waits for the copy,
    and the copied tensor is marked as used there (it was allocated on the
    side stream, and the caching allocator must not hand its memory out
    while the scan still reads it). The device's graphs give way to it
    (:func:`~..parallel.step_graph.releasing`). Span ``stage.upload``:
    the host's issue of the copy (its time on the card is the profiler's
    ``Memcpy HtoD`` event)."""
    if device.type != "cuda":
        return host.to(device)
    side = side_stream(device)
    with spans.span("stage.upload"):
        with torch.cuda.stream(side):
            staged = releasing(device,
                               lambda: host.to(device, non_blocking=True))
        main = torch.cuda.current_stream(device)
        main.wait_stream(side)
        staged.record_stream(main)
    return staged


def device_ints(values, device: torch.device) -> torch.Tensor:
    """Host ints (a scalar or a sequence) as an int64 tensor on ``device``,
    copied from pinned memory without blocking the host on a CUDA device:
    a scan step's row lengths, which it then reads on the device. Span
    ``dispatch.lengths``."""
    with spans.span("dispatch.lengths"):
        host = torch.from_numpy(np.asarray(values, np.int64))
        if device.type != "cuda":
            return host.to(device)
        return host.pin_memory().to(device, non_blocking=True)


def stage_rows_host(episodes, ns, n_pad: int, transfer: str, e_pad: int,
                    device):
    """Fill a fresh (pinned, for a CUDA device) host buffer with the wire
    rows and upload it with one copy (:func:`upload`); no computation runs
    on the device. Returns the staged triple (tensor [e_pad, n_pad],
    ns_pad, n_real)."""
    ns_pad = np.zeros(e_pad, np.int32)
    ns_pad[: len(ns)] = ns
    host = fill_wire_rows(episodes, n_pad, transfer, e_pad,
                          pinned=device.type == "cuda")
    return upload(host, device), ns_pad, len(episodes)


def pad_wire_on_device(episode: torch.Tensor, target: int) -> torch.Tensor:
    """Pad a staged wire episode to ``target`` samples with silence
    (uint8 pads with 128, the μ-law code of 0), on its own device."""
    short = target - episode.shape[0]
    if short <= 0:
        return episode
    fill = silence_code(episode.dtype)
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


def staged_width(cfg, chunk: int, overlap: int, n_max: int) -> int:
    """Samples per staged episode row: the longest episode's windows
    padded to whole slabs, plus the last window's overlap."""
    n_windows = max(-(-n_max // chunk), 1)
    s = effective_slab(cfg, n_windows)
    return -(-n_windows // s) * s * chunk + overlap


def scan_slab(cfg, chunk: int, n_max: int, n_windows_pad: int) -> int:
    """The slab a staged buffer of ``n_windows_pad`` windows scans with:
    the staging policy's, or the largest divisor when the buffer was
    staged under another policy."""
    slab = effective_slab(cfg, max(-(-n_max // chunk), 1))
    if n_windows_pad % slab:
        slab = divisor_slab(n_windows_pad, cfg.slab)
    return slab


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


# ------------------------------------------------------- the single query
def _corr_windows(windows, spectrum, fft_len: int, crop: int, fft_impl: str,
                  plain: bool, work: dict | None):
    """f32 windows [B, W] × one query → [B, crop] correlations (JAX
    ``_corr_windows``). ``spectrum``: the scrambled (s_r, s_i) [1, n] pair
    for ``"vpu"``, the digit-reversed plane views [1, G, c] for ``"mxu"``,
    conj(full spectrum) [n] for ``"xla_packed"``, the rfft [n//2+1] for
    ``"xla"``."""
    if fft_impl == "mxu":
        return corr_slab_mxu(windows, spectrum[0], spectrum[1], crop)[:, 0]
    if fft_impl == "xla_packed":
        return corr_single_query_packed(windows, spectrum, crop)
    if fft_impl == "vpu":
        return corr_single_query_vpu(
            windows, spectrum[0], spectrum[1], crop, plain=plain, work=work
        )
    x = torch.fft.rfft(windows, n=fft_len)
    return torch.fft.irfft(x * spectrum.conj(), n=fft_len)[..., :crop]


def single_query_slab(
    windows, valid, spectrum, inv_ac, crop: int, fft_len: int,
    distance: int, n_peaks: int, block: int, fft_impl: str,
    peaks_impl: str, plain: bool = False, work: dict | None = None,
):
    """Peaks of one query against a slab of B windows → (pos, h, prom),
    each [B, n_peaks].

    The fused path (``"vpu"`` + ``"pallas"``): ``windows`` in the wire
    dtype, ``spectrum`` the (s_r, s_i) pair of
    ``scrambled_query_spectra(pack=False)``; window pairs share each
    transform, and ``inv_ac`` scales the planes inside the peak
    reduction's read. Otherwise: f32 windows, ``spectrum`` in the form
    :func:`_corr_windows` takes, and the [B, crop] correlation goes to
    ``peaks_impl``'s picker. ``valid`` [B] holds the windows' valid
    correlation lengths; ``inv_ac`` is a 0-d f32 tensor. ``plain`` runs
    every kernel's plain version; ``work`` keeps the FFT planes across
    slabs.
    """
    B = windows.shape[0]
    if is_fused(fft_impl, peaks_impl):
        yr, yi = corr_single_query_vpu_planes_wire(
            windows, spectrum[0], spectrum[1], crop, plain=plain, work=work
        )
        L = 2 * yr.shape[0]  # logical rows incl. an odd slab's pad
        valid = torch.nn.functional.pad(valid, (0, L - B))  # pad: nothing
        out = pick_peaks_packed(
            yr, yi, inv_ac.expand(L), valid, distance, n_peaks, block,
            plain=plain,
        )
        return tuple(a[:B] for a in out)
    c = _corr_windows(
        windows, spectrum, fft_len, crop, fft_impl, plain, work
    ) * inv_ac
    return pick_peaks_dispatch(
        c, valid, distance, n_peaks, block, peaks_impl, plain=plain
    )


def _match_episode_resident(
    episode, n: int, sample_f, inv_ac, chunk: int, window: int, m: int,
    fft_len: int, valid_max: int, distance: int, n_peaks: int, block: int,
    slab: int, n_slabs: int, fft_impl: str = "vpu",
    peaks_impl: str = "pallas", plain: bool = False,
    work: dict | None = None,
):
    """Scan one staged episode against one query: a Python loop over
    ``n_slabs`` slabs from the episode's start (the live path scans one
    group of slabs per call, on the group's slice). The episode is padded
    with wire silence on its device to cover the windows; off the fused
    path it is dequantized there once before windowing. ``n`` (the
    episode's length) and ``inv_ac`` are host numbers or 0-d tensors on
    the episode's device; with tensors no host value is read or copied,
    so a CUDA graph can capture the scan. Returns (pos, h, prom), each
    [n_slabs·slab, n_peaks], on the episode's device."""
    k_rows = window_rows(window, chunk)
    episode = pad_wire_on_device(
        episode, (n_slabs * slab + k_rows) * chunk
    )
    if not is_fused(fft_impl, peaks_impl):
        episode = dequant_to_f32(episode)
    dev = episode.device
    crop = correlation_crop(valid_max, block, fft_len, fft_impl, peaks_impl)
    inv = torch.as_tensor(inv_ac, dtype=torch.float32).to(dev).reshape(())
    work = {} if work is None else work
    outs = []
    for s in range(n_slabs):
        base = s * slab
        starts = (base + torch.arange(slab, device=dev)) * chunk
        windows = windows_from_episode(episode, base, slab, chunk, window)
        win_len = (n - starts).clamp(0, window)
        valid = (win_len - m + 1).clamp(min=0)
        outs.append(single_query_slab(
            windows, valid, sample_f, inv, crop, fft_len, distance, n_peaks,
            block, fft_impl, peaks_impl, plain, work,
        ))
    return tuple(torch.cat([o[i] for o in outs]) for i in range(3))


def _match_batch_resident(episodes, ns, sample_f, inv_ac, **kw):
    """:func:`_match_episode_resident` over the rows of a staged [E, Npad]
    batch, sharing one set of work planes → (pos, h, prom), each [E,
    n_slabs·slab, n_peaks]. ``ns`` [E] int64 and ``inv_ac`` (0-d f32) are
    tensors on the batch's device, as the JAX package passes them: no host
    value is read or copied, so a CUDA graph can capture the scan."""
    work: dict = {}
    per = [
        _match_episode_resident(
            episodes[e], ns[e], sample_f, inv_ac, work=work, **kw
        )
        for e in range(episodes.shape[0])
    ]
    return tuple(torch.stack([p[i] for p in per]) for i in range(3))


class SnippetMatcher:
    """Scan episodes for one query snippet (BASELINE config #2), reusable
    across episodes.

    ``device``: the torch device that stages and scans (default the
    current CUDA device; ``"cpu"`` runs every kernel's plain version).
    Construction allocates nothing on it. ``plain``: run every kernel's
    plain PyTorch version on any device (the reference path).
    ``graphs``: on a CUDA device, replay the scans of :meth:`match_staged`
    (one call, or each group of slabs of the live-progress path) and of
    :meth:`match_staged_batch` as CUDA graphs captured once per shape
    (:class:`~..parallel.step_graph.StepGraphs`), so a matcher reused
    across episodes, as the matcher CLI's, replays them; ``graphs=False``
    and a ``plain`` matcher run them eagerly. The matchers that
    :func:`calc_chunks` and ``match()`` build share one cache instead
    (:meth:`for_call`).
    """

    def __init__(
        self,
        snippet: np.ndarray,
        sr: int,
        config: MatchConfig | None = None,
        device="cuda",
        plain: bool = False,
        graphs: bool = True,
    ):
        self.sr = int(sr)
        self.config = cfg = config or MatchConfig()
        self.device = torch.device(device)
        self.plain = bool(plain)
        self.step_graphs = StepGraphs() if graphs and not plain else None
        self.snippet: PreparedSnippet = prepare_snippet(snippet)
        overlap_secs = (
            cfg.overlap_secs if cfg.overlap_secs is not None
            else self.snippet.m / self.sr
        )
        # +2: a peak on the exact hop boundary would otherwise sit on the
        # excluded edge column of both adjacent windows
        self.overlap = int(round(overlap_secs * self.sr)) + 2
        self.chunk = int(round(cfg.chunk_secs * self.sr))
        if self.chunk + self.overlap < self.snippet.m:
            # a window shorter than the snippet could never emit a peak
            log.warning(
                "chunk+overlap (%d samples) < snippet length (%d); raising "
                "overlap to the snippet length so matches stay findable",
                self.chunk + self.overlap, self.snippet.m,
            )
            self.overlap = self.snippet.m + 2
        self.window = self.chunk + self.overlap
        self.valid = self.window - self.snippet.m + 1
        self.fft_len = fft_length(self.window + self.snippet.m - 1)
        self.fft_impl = resolve_fft_impl(cfg, self.fft_len)
        check_fft_len(self.fft_impl, self.fft_len, self.device)
        self.distance_samples = int(cfg.distance_secs) * self.sr
        per_chunk = self.valid // max(self.distance_samples, 1) + 2
        self.n_peaks = min(per_chunk, cfg.max_peaks_per_chunk)
        if per_chunk > cfg.max_peaks_per_chunk:
            log.warning(
                "distance %.1fs allows %d peaks/chunk; capping at %d",
                cfg.distance_secs, per_chunk, cfg.max_peaks_per_chunk,
            )
        self._sample_f_cache = None
        self._inv_tensors: dict = {}  # scale → inv_ac, 0-d on the device
        self._spectrum_copied = False  # see _scan

    @classmethod
    def for_call(cls, snippet: np.ndarray, sr: int,
                 config: MatchConfig | None = None,
                 device="cuda") -> "SnippetMatcher":
        """The matcher of one :func:`calc_chunks` or ``match()`` call: its
        scans go through :data:`CALL_GRAPHS`, its spectrum copied into the
        graph, so that every snippet of one length shares the key."""
        matcher = cls(snippet, sr, config, device=device, graphs=False)
        matcher.step_graphs = CALL_GRAPHS
        matcher._spectrum_copied = True
        return matcher

    @property
    def _sample_f(self):
        """The query spectrum on the matcher's device, computed on first
        use (the device's graphs giving way to it, see
        :func:`~..parallel.step_graph.releasing`), in the form
        :func:`single_query_slab` takes for :attr:`fft_impl`."""
        if self._sample_f_cache is None:
            self._sample_f_cache = releasing(self.device, self._spectrum)
        return self._sample_f_cache

    def _spectrum(self):
        snip = torch.from_numpy(self.snippet.data).to(self.device)
        n = self.fft_len
        if self.fft_impl == "vpu":
            return scrambled_query_spectra(snip[None], n, False)
        if self.fft_impl == "mxu":
            return scrambled_spectra_parts(snip[None], n)
        if self.fft_impl == "xla_packed":
            return query_spectrum(snip, n)
        return torch.fft.rfft(snip, n=n)

    def _scan_kwargs(self, slab: int, n_slabs: int) -> dict:
        return dict(
            chunk=self.chunk, window=self.window, m=self.snippet.m,
            fft_len=self.fft_len, valid_max=self.valid,
            distance=self.distance_samples, n_peaks=self.n_peaks,
            block=self.config.block, slab=slab, n_slabs=n_slabs,
            fft_impl=self.fft_impl, peaks_impl=self.config.peaks_impl,
            plain=self.plain,
        )

    def _inv_ac(self, scale: bool) -> np.float32:
        return np.float32(self.snippet.inv_autocorr if scale else 1.0)

    def _scan(self, resident, name: str, staged, ns, scale: bool,
              kw: dict):
        """``resident`` (:func:`_match_episode_resident` or
        :func:`_match_batch_resident`) of staged rows with the row lengths
        ``ns`` and the inverse autocorrelation as tensors on their device,
        replayed from :attr:`step_graphs` where there is one under the key
        ``name`` and ``kw``. The query spectrum is held (read in place),
        or copied into the graph in a matcher made by :meth:`for_call`."""
        dev = staged.device
        if scale not in self._inv_tensors:
            self._inv_tensors[scale] = torch.tensor(
                self._inv_ac(scale), dtype=torch.float32, device=dev)
        spec = self._sample_f
        paired = isinstance(spec, tuple)
        spectrum = tuple(spec) if paired else (spec,)
        copied = (staged, device_ints(ns, dev), self._inv_tensors[scale])

        def step(rows, ns_dev, inv, *spectrum):
            return resident(
                rows, ns_dev, spectrum if paired else spectrum[0], inv, **kw)

        key = (name,) + tuple(sorted(kw.items()))
        if self._spectrum_copied:
            return run_step(self.step_graphs, key, step, copied + spectrum)
        return run_step(self.step_graphs, key, step, copied, spectrum)

    def _scan_episode(self, episode_dev, n: int, scale: bool, kw: dict):
        """:func:`_match_episode_resident` of a staged episode, through
        :meth:`_scan`."""
        return self._scan(_match_episode_resident, "episode", episode_dev, n,
                          scale, kw)

    def stage(self, samples: np.ndarray, n_samples: int | None = None):
        """Pad an episode to whole slabs of windows in the wire dtype and
        upload it with one copy from a pinned host buffer; no computation
        runs on the device. ``n_samples`` truncates or zero-extends the
        stream first. Returns (episode tensor [Npad], n) for
        :meth:`match_staged`. Span ``stage``."""
        with spans.span("stage"):
            samples = np.ascontiguousarray(samples)
            if n_samples is not None:
                if n_samples <= len(samples):
                    samples = samples[:n_samples]
                else:
                    tail = np.zeros(n_samples - len(samples), samples.dtype)
                    samples = np.concatenate([samples, tail])
            n = len(samples)
            width = staged_width(self.config, self.chunk, self.overlap, n)
            staged, _, _ = stage_rows_host(
                [samples], [n], width, self.config.transfer_dtype, 1,
                self.device)
        return staged[0], n

    def stage_batch(self, episodes: Sequence[np.ndarray]):
        """Stage several episodes as one [E, Npad] tensor (one copy; every
        row padded to the longest). Returns (tensor, ns) for
        :meth:`match_staged_batch`. Span ``stage``."""
        with spans.span("stage"):
            ns = np.array([len(e) for e in episodes], np.int32)
            n_max = int(ns.max()) if len(ns) else 0
            width = staged_width(self.config, self.chunk, self.overlap,
                                 n_max)
            staged, _, _ = stage_rows_host(
                episodes, ns, width, self.config.transfer_dtype,
                len(episodes), self.device,
            )
        return staged, ns

    def match(
        self,
        samples: np.ndarray,
        scale: bool = True,
        n_samples: int | None = None,
        progress: Callable[[str, int], None] | None = None,
    ) -> list[Peak]:
        """Scan an episode; returns deduped peaks sorted by position.
        ``scale=False`` leaves correlations (and prominences) unscaled by
        the inverse autocorrelation. ``progress`` receives
        ("start"|"finish", chunk_index) callbacks."""
        return self.match_staged(
            self.stage(samples, n_samples), scale=scale, progress=progress
        )

    def _extract_peaks(
        self, pos, h, prom, n_windows: int, progress=None
    ) -> list[Peak]:
        """Rebase each window's candidates and dedup across windows (span
        ``collect.peaks``)."""
        cfg = self.config
        candidates: list[Peak] = []
        with spans.span("collect.peaks"):
            for k in range(n_windows):
                for s in range(pos.shape[1]):
                    if (np.isfinite(h[k, s])
                            and prom[k, s] >= cfg.min_prominence):
                        candidates.append(
                            Peak(
                                position=int(pos[k, s]) + self.chunk * k,
                                height=float(h[k, s]),
                                prominence=float(prom[k, s]),
                            )
                        )
                if progress:
                    progress("finish", k)
            return overshadow_filter(candidates, self.sr, cfg.distance_secs)

    def match_staged(
        self,
        staged,
        scale: bool = True,
        progress: Callable[[str, int], None] | None = None,
    ) -> list[Peak]:
        """Scan an episode uploaded with :meth:`stage`. With ``progress``
        and more than one slab, slabs run in groups of
        ``progress_slabs_per_dispatch`` (:meth:`_match_staged_live`)."""
        episode_dev, n = staged
        if n == 0:
            return []
        n_windows = max(-(-n // self.chunk), 1)
        n_windows_pad = (episode_dev.shape[0] - self.overlap) // self.chunk
        B = scan_slab(self.config, self.chunk, n, n_windows_pad)
        n_slabs = n_windows_pad // B
        if (progress and n_slabs > 1
                and self.config.progress_slabs_per_dispatch > 0):
            return self._match_staged_live(
                episode_dev, n, scale, n_windows, n_slabs, B, progress)
        if progress:
            for k in range(n_windows):
                progress("start", k)
        out = self._scan_episode(episode_dev, n, scale,
                                 self._scan_kwargs(B, n_slabs))
        pos, h, prom = (a.cpu().numpy() for a in out)
        return self._extract_peaks(pos, h, prom, n_windows, progress)

    def _match_staged_live(
        self, episode_dev, n: int, scale: bool, n_windows: int,
        n_slabs: int, B: int, progress: Callable[[str, int], None],
    ) -> list[Peak]:
        """Scan in groups of ``progress_slabs_per_dispatch`` slabs: a
        group's windows get "start" when its work is enqueued and
        "finish" once its results are read back, so progress follows the
        device. Same results as the one-call path. Each group scans its
        own slice of the episode from the slice's start, so that the full
        groups of every episode staged with slab ``B`` share one key of
        :attr:`step_graphs`."""
        g = self.config.progress_slabs_per_dispatch
        k_rows = window_rows(self.window, self.chunk)
        # pad once, and dequantize once off the fused path, for all groups
        episode_dev = pad_wire_on_device(
            episode_dev, (n_slabs * B + k_rows) * self.chunk
        )
        if not is_fused(self.fft_impl, self.config.peaks_impl):
            episode_dev = dequant_to_f32(episode_dev)
        parts = []
        for a in range(0, n_slabs, g):
            gg = min(g, n_slabs - a)
            w_lo, w_hi = a * B, min((a + gg) * B, n_windows)
            for k in range(w_lo, w_hi):
                progress("start", k)
            lo = w_lo * self.chunk  # the JAX package traces a base0
            out = self._scan_episode(
                episode_dev[lo : (w_lo + gg * B + k_rows) * self.chunk],
                n - lo, scale, self._scan_kwargs(B, gg),
            )
            parts.append([t.cpu().numpy() for t in out])
            for k in range(w_lo, w_hi):
                progress("finish", k)
        pos, h, prom = (np.concatenate([p[i] for p in parts])
                        for i in range(3))
        return self._extract_peaks(pos, h, prom, n_windows)

    def match_staged_batch(
        self, staged, scale: bool = True
    ) -> list[list[Peak]]:
        """Scan a :meth:`stage_batch` upload → peaks per episode."""
        episodes_dev, ns = staged
        n_windows_pad = (episodes_dev.shape[1] - self.overlap) // self.chunk
        n_max = int(ns.max()) if len(ns) else 0
        B = scan_slab(self.config, self.chunk, n_max, n_windows_pad)
        out = self._scan(_match_batch_resident, "batch", episodes_dev, ns,
                         scale, self._scan_kwargs(B, n_windows_pad // B))
        pos, h, prom = (a.cpu().numpy() for a in out)
        return [
            self._extract_peaks(
                pos[e], h[e], prom[e], max(-(-int(ns[e]) // self.chunk), 1)
            )
            for e in range(len(ns))
        ]


# The scans of calc_chunks and match(), which build a matcher a call
# (SnippetMatcher.for_call): one cache for the process, so that a second
# call of one shape replays the graph its first two calls captured, as a
# second call of the JAX package's jitted scan reuses its program. The
# query spectrum is a copied input here, so that every snippet of one
# length shares the key; the cache holds no matcher and no snippet, only
# its graphs' own buffers. Its graphs hold their step's work planes in the
# device's shared pool (see parallel/step_graph.py), which gives way to
# any other step that does not fit beside it: released with every graph
# of the device, their keys kept, when a capture finds the store full or
# a call runs out of memory.
CALL_GRAPHS = StepGraphs()


def calc_chunks(
    sr: int,
    samples: np.ndarray,
    snippet: np.ndarray,
    scale: bool = True,
    config: MatchConfig | None = None,
    n_samples: int | None = None,
    progress: Callable[[str, int], None] | None = None,
    device="cuda",
) -> list[Peak]:
    """Functional entry point: one :meth:`SnippetMatcher.for_call` on
    ``device``, one :meth:`~SnippetMatcher.match`."""
    return SnippetMatcher.for_call(snippet, sr, config, device=device).match(
        samples, scale=scale, n_samples=n_samples, progress=progress
    )
