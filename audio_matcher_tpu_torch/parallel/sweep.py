"""The resident scan on one device (port of ``parallel/sweep.py``).

A group of episodes is staged once as a flat [E, Npad] wire-dtype tensor;
overlap-save windows are strided views of it. Per slab of windows, by
query count, ``fft_impl`` and ``peaks_impl`` (the JAX package's branches of
``resident_match_step``):

  * Q ≥ 2, ``"vpu"`` + ``"pallas"`` (BASELINE config #3, the batch scan):
    every window's forward FFT is shared across the queries and query
    pairs pack into the inverse transforms,
    windows (wire) → corr_slab_vpu_planes_wire → pick_peaks_packed;
  * Q = 1, ``"vpu"`` + ``"pallas"`` (config #2 through the scanner):
    window pairs pack into each transform instead, as ``SnippetMatcher``
    scans, windows (wire) → corr_single_query_vpu_planes_wire →
    pick_peaks_packed;
  * every other pair: the episode is dequantized on the device and the
    [B, Q, V] correlation is computed by ``fft_impl`` (``"vpu"``: the FFT
    kernels from f32 windows with query pairs, also at Q = 1;
    ``"xla_packed"``: ``torch.fft`` with window pairs at Q = 1 and query
    pairs at Q ≥ 2, also the ``"vpu"`` fallback below ``fft_len`` 2^14;
    ``"xla"``: ``torch.fft`` rfft/irfft; ``"mxu"``: the matmul FFT), then
    peaks come from pick_peaks_dispatch under ``peaks_impl``.

On the host, :meth:`ShardedScanner.scan_collect` rebases positions and
dedups across windows with ``overshadow_filter``.
:class:`ShardedSpectrogramScanner` scans the same staged rows in the
spectrogram domain (BASELINE config #4: log-mel fingerprints, frame NCC,
the multi-pass picker; torch ops). :func:`sweep_archive` runs either
scanner over an archive of files, group by group, with prefetched
decode, pinned staging uploaded on a side stream and a resumable progress
store.

On several devices (a :class:`~.mesh.Mesh`, or a list of devices) a staged
group's rows shard over the flattened mesh in contiguous blocks of
⌈E/n⌉ rows, block i on device i; each block is uploaded on its device's
side stream, scanned there by the same step (a host thread a device
issues its shards) and read back after its own event, and the blocks
concatenate in row order on the host. The scan is
collective-free, as the JAX package's ``shard_map`` is. The legacy windows
path :meth:`ShardedScanner.scan` shards an [E, C, W] window tensor over
the mesh's (data, seq) grid, and :func:`sweep_archive` splits its files
over the processes of a cluster (``mesh.init_distributed``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from ..models.matcher import (
    MatchConfig,
    check_fft_len,
    correlation_crop,
    describe_path,
    device_ints,
    fill_wire_rows,
    is_fused,
    overshadow_filter,
    pad_wire_on_device,
    read_back,
    resolve_fft_impl,
    scan_slab,
    single_query_slab,
    stage_rows_host,
    staged_width,
    upload,
    window_rows,
    windows_from_episode,
)
from ..models.spectrogram import SpectrogramConfig, describe_spectrogram_path
from ..ops.correlate import (
    corr_single_query_packed,
    corr_slab_xla_packed,
    fft_length,
    packed_query_spectra,
    prepare_snippet,
)
from ..ops.cuda_fft import (
    corr_slab_vpu,
    corr_slab_vpu_planes_wire,
    scrambled_query_spectra,
)
from ..ops.mxu_fft import corr_slab_mxu, scrambled_spectra_parts
from ..ops.peaks import (
    Peak,
    pick_peaks_core,
    pick_peaks_dispatch,
    pick_peaks_packed,
)
from ..ops.stft import (
    log_mel,
    mel_filterbank,
    n_frames_of,
    ncc_frames_multi_core,
    stft_log_mel_core,
)
from ..ops.wire import dequant_to_f32
from ..utils import spans
from .mesh import Mesh, make_local_mesh, process_count, process_index
from .step_graph import StepGraphs, releasing, run_step

log = logging.getLogger("audio_matcher_torch.sweep")


@dataclasses.dataclass
class _Query:
    m: int
    inv_autocorr: float


@dataclasses.dataclass(frozen=True)
class QueryState:
    """What the scan holds of its queries (this system's weights): their
    spectra as f32 real and imaginary parts (``"vpu"``: the query-pair
    spectra of ``scrambled_query_spectra(pack=True)``, [Qh, n] each;
    ``"xla_packed"``: ``packed_query_spectra`` in natural order, [Qh, n];
    ``"xla"``: the rfft, [Q, n//2+1]; ``"mxu"``: the digit-reversed plane
    views of ``scrambled_spectra_parts``, [Q, G, c]), the inverse
    autocorrelations [Q] f32 and the snippet lengths [Q]."""

    t_r: torch.Tensor
    t_i: torch.Tensor
    inv_ac: torch.Tensor
    m: torch.Tensor

    def to(self, device) -> "QueryState":
        """The state on ``device`` (the same tensors if they are there)."""
        return QueryState(self.t_r.to(device), self.t_i.to(device),
                          self.inv_ac.to(device), self.m.to(device))


def query_state_from_numpy(t_r, t_i, inv_ac, m, device) -> QueryState:
    """Carry a prepared query state across (e.g. the JAX scanner's
    ``_sample_f_resident``, ``_inv_ac`` and ``_m`` as numpy arrays; for
    ``"xla_packed"`` and ``"xla"`` the real and imaginary parts of its
    complex spectra), so that both packages scan with identical
    spectra."""
    dev = torch.device(device)
    return QueryState(
        t_r=torch.tensor(np.asarray(t_r, np.float32), device=dev),
        t_i=torch.tensor(np.asarray(t_i, np.float32), device=dev),
        inv_ac=torch.tensor(np.asarray(inv_ac, np.float32), device=dev),
        m=torch.tensor(np.asarray(m, np.int64), device=dev),
    )


def _corr_slab(windows, spectra, fft_len: int, crop: int, fft_impl: str,
               Q: int, plain: bool, work: dict):
    """f32 windows [B, W] × Q queries → [B, Q, crop] correlations (the
    JAX scanner's non-fused branches). ``spectra``: (t_r, t_i) for
    ``"vpu"`` and ``"mxu"``, complex for ``"xla_packed"`` and ``"xla"``."""
    if fft_impl == "mxu":
        return corr_slab_mxu(windows, spectra[0], spectra[1], crop)
    if fft_impl == "xla_packed":
        if Q == 1:  # window pairs; the pair row of one query is conj(S0)
            return corr_single_query_packed(windows, spectra[0], crop)[:, None]
        return corr_slab_xla_packed(windows, spectra, crop)[:, :Q]
    if fft_impl == "vpu":
        return corr_slab_vpu(
            windows, spectra[0], spectra[1], crop, plain=plain, work=work
        )[:, :Q]
    x = torch.fft.rfft(windows, n=fft_len)  # [B, F], shared by the queries
    spec = x[:, None, :] * spectra.conj()[None]
    return torch.fft.irfft(spec, n=fft_len)[..., :crop]


def resident_match_step(
    chunk: int,
    window: int,
    fft_len: int,
    valid_max: int,
    distance: int,
    n_peaks: int,
    block: int,
    slab: int,
    n_slabs: int,
    fft_impl: str = "vpu",
    peaks_impl: str = "pallas",
    plain: bool = False,
):
    """The resident scan of a staged batch.

    Returned fn: (episodes [E, Npad] wire, ns [E] int64 on the episodes'
    device (host ints are copied there), t_r, t_i (:class:`QueryState`'s
    spectra), inv_ac [Q], m [Q]) → (pos, h, prom) each [E, Q,
    n_slabs·slab, S]. Episodes and slabs run in a Python loop that reuses
    one slab's intermediate planes; no host value is read from the
    device, so a CUDA graph can capture it. ``plain=True`` runs every
    kernel's plain PyTorch version instead (the reference path).
    """
    fused = is_fused(fft_impl, peaks_impl)
    crop = correlation_crop(valid_max, block, fft_len, fft_impl, peaks_impl)
    target = (n_slabs * slab + window_rows(window, chunk)) * chunk

    def slab_single(windows, win_len, spectra, inv_ac, m, work):
        # one query: window pairs share each transform, as SnippetMatcher
        # scans; the pair spectra of one query are its single-query form
        # (pack=True equals pack=False at Q = 1)
        valid = (win_len - m[0] + 1).clamp(min=0)
        return [a[None] for a in single_query_slab(
            windows, valid, spectra, inv_ac[0], crop, fft_len, distance,
            n_peaks, block, fft_impl, peaks_impl, plain, work,
        )]

    def slab_vpu(windows, win_len, spectra, inv_ac, m, work):
        t_r, t_i = spectra
        Q = inv_ac.shape[0]
        yr, yi = corr_slab_vpu_planes_wire(
            windows, t_r, t_i, crop, plain=plain, work=work
        )
        Q2 = 2 * t_r.shape[0]  # queries incl. the odd-Q pad
        inv_pad = torch.nn.functional.pad(inv_ac, (0, Q2 - Q))
        m_pad = torch.nn.functional.pad(m, (0, Q2 - Q), value=1)
        vq2 = (win_len[:, None] - m_pad[None, :] + 1).clamp(min=0)
        vq2[:, Q:] = 0  # the pad query emits nothing
        picked = pick_peaks_packed(
            yr, yi, inv_pad.repeat(slab),  # logical rows: q fastest
            vq2.reshape(-1), distance, n_peaks, block, plain=plain,
        )
        return [a.reshape(slab, Q2, -1)[:, :Q].transpose(0, 1)
                for a in picked]  # [Q, B, S] triplets

    def slab_dense(windows, win_len, spectra, inv_ac, m, work):
        Q = inv_ac.shape[0]
        c = _corr_slab(windows, spectra, fft_len, crop, fft_impl, Q, plain,
                       work)
        c = c * inv_ac[None, :, None]
        vq = (win_len[:, None] - m[None, :] + 1).clamp(min=0)  # [B, Q]
        picked = pick_peaks_dispatch(
            c, vq, distance, n_peaks, block, peaks_impl, plain=plain
        )
        return [a.transpose(0, 1) for a in picked]

    def per_episode(episode, n, slab_fn, spectra, inv_ac, m, work):
        dev = episode.device
        episode = pad_wire_on_device(episode, target)
        if not fused:
            episode = dequant_to_f32(episode)
        outs = []
        for s in range(n_slabs):
            base = s * slab
            starts = (base + torch.arange(slab, device=dev)) * chunk
            windows = windows_from_episode(episode, base, slab, chunk, window)
            win_len = (n - starts).clamp(0, window)
            outs.append(slab_fn(windows, win_len, spectra, inv_ac, m, work))
        return [torch.cat([o[i] for o in outs], dim=1) for i in range(3)]

    def step(episodes, ns, t_r, t_i, inv_ac, m):
        if not fused:
            slab_fn = slab_dense
        else:
            slab_fn = slab_single if inv_ac.shape[0] == 1 else slab_vpu
        spectra = (
            (t_r, t_i) if fft_impl in ("vpu", "mxu")
            else torch.complex(t_r, t_i)
        )
        ns = torch.as_tensor(ns, dtype=torch.int64, device=episodes.device)
        work: dict = {}
        per = [
            per_episode(episodes[e], ns[e], slab_fn, spectra, inv_ac, m, work)
            for e in range(episodes.shape[0])
        ]
        return tuple(torch.stack([p[i] for p in per]) for i in range(3))

    return step


@dataclasses.dataclass(frozen=True)
class ShardedRows:
    """A group's wire rows staged over several devices: ``blocks[i]`` is
    (first row, rows [r, Npad]) on its device, in row order (a device the
    rows do not reach holds no block), and ``host`` the pinned buffer they
    were copied from, held until the scan that reads them is collected."""

    blocks: tuple[tuple[int, torch.Tensor], ...]
    host: torch.Tensor


def _on(device: torch.device):
    """``device`` as the current CUDA device (nothing on the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _issue_stream(device: torch.device):
    """The calling thread's current stream of ``device`` (None on the
    CPU): a shard's thread issues its scan there, behind the upload."""
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


def _on_stream(stream):
    """``stream`` (and its device) current in this thread; nothing for
    None."""
    if stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream)


def _ready_event(device: torch.device):
    """A CUDA event behind the work queued so far on ``device``'s current
    stream (None on the CPU)."""
    if device.type != "cuda":
        return None
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(device))
    return ready


class _Scanner:
    """What the two scanners share: the devices, the staging of a group's
    wire rows, the event behind a dispatched scan and the stage → scan →
    collect chain. A scanner gives the staged width of its rows
    (:meth:`_width`), builds its per-device state (:meth:`_prepare`), runs
    the scan of staged rows on their device (:meth:`_scan`) and turns the
    arrays read back into peaks (:meth:`_peaks`).

    ``device``: one device, a list of devices or a :class:`~.mesh.Mesh`.
    On one device a group stages as one tensor and scans in one call; on
    several, its rows shard over ``mesh.flat`` (:class:`ShardedRows`).
    ``graphs``: on CUDA devices, replay each scan step as a CUDA graph
    captured once per shape (:attr:`step_graphs`, a
    :class:`~.step_graph.StepGraphs`); False runs it eagerly.

    Spans (``utils/spans.py``): ``stage``, ``dispatch`` and ``collect``
    around the three calls, with the group's sequence number, which the
    staged and dispatched tuples carry (:class:`~..utils.spans.Grouped`);
    ``dispatch.issue`` around each card's launches on a mesh, and
    ``collect.peaks`` around :meth:`_peaks`."""

    def __init__(self, device, graphs: bool):
        self.step_graphs = StepGraphs() if graphs else None
        self._groups = itertools.count()  # the staged groups' numbers
        if isinstance(device, Mesh):
            self.mesh = device
        elif isinstance(device, (list, tuple)):
            self.mesh = Mesh.of(device)
        else:
            self.mesh = Mesh.of([device])
        self.devices = self.mesh.flat
        self.device = self.devices[0]

    def _where(self) -> str:
        """The device or the mesh, for the log."""
        if len(self.devices) == 1:
            return f"device {self.device}"
        return self.mesh.describe()

    def _row_blocks(self, e_pad: int):
        """(device, first row, end row) of each shard that holds rows:
        ⌈e_pad / n⌉ rows a device in mesh order, the last block shorter."""
        per = -(-e_pad // len(self.devices))
        return [(d, i * per, min((i + 1) * per, e_pad))
                for i, d in enumerate(self.devices) if i * per < e_pad]

    def stage_resident(self, episodes: Sequence[np.ndarray], pad_to=None):
        """Pack the batch into one fresh [E, Npad] wire-dtype host buffer
        (pinned for a CUDA device) and upload it (on a side stream for a
        CUDA device, see :func:`upload`): with one copy on one device, or
        one copy a shard on a mesh. ``pad_to``: minimum episode count
        (silence rows)."""
        group = next(self._groups)
        with spans.span("stage", group):
            return spans.Grouped(self._stage(episodes, pad_to), group)

    def _stage(self, episodes, pad_to):
        ns = np.array([len(e) for e in episodes], np.int32)
        n_max = int(ns.max()) if len(ns) else 0
        e_pad = max(len(episodes), int(pad_to or 0))
        width = self._width(n_max)
        transfer = self.config.transfer_dtype
        if len(self.devices) == 1:
            return stage_rows_host(episodes, ns, width, transfer, e_pad,
                                   self.device)
        ns_pad = np.zeros(e_pad, np.int32)
        ns_pad[: len(ns)] = ns
        host = fill_wire_rows(episodes, width, transfer, e_pad,
                              pinned=self.device.type == "cuda")
        blocks = tuple((a, upload(host[a:b], d))
                       for d, a, b in self._row_blocks(e_pad))
        return ShardedRows(blocks, host), ns_pad, len(episodes)

    def scan_dispatch(self, staged, scale: bool = True):
        """Run the scan of a :meth:`stage_resident` upload → ((pos, h,
        prom), ns, n_real, ready): the device tensors may still be in
        flight; ``ready`` is a CUDA event behind them (None on the CPU).
        On a mesh, (pos, h, prom) and ``ready`` are lists with one entry a
        shard, each shard scanned on its own device. Each device's shards
        are issued by a host thread of its own: issuing a card's launches
        blocks while its launch queue is full, so one thread would start
        each card only when the card before it had nearly finished."""
        group = spans.group_of(staged)
        with spans.span("dispatch", group):
            return spans.Grouped(self._dispatch(staged, scale, group), group)

    def _dispatch(self, staged, scale: bool, group):
        rows, ns, n_real = staged
        n_max = int(ns.max()) if len(ns) else 0
        if not isinstance(rows, ShardedRows):
            outs = self._scan(rows, ns, scale, n_max)
            return outs, ns, n_real, _ready_event(rows.device)
        into = spans.sink()

        def issue(shards, stream):
            device = shards[0][1].device
            with (_on_stream(stream),
                  spans.issue_span(into, "dispatch.issue", group, device)):
                return [(self._scan(block, ns[a : a + block.shape[0]],
                                    scale, n_max),
                         _ready_event(block.device)) for a, block in shards]

        by_device: dict = {}
        for i, (_, block) in enumerate(rows.blocks):
            self._prepare(block.device)
            by_device.setdefault(block.device, []).append(i)
        done = [None] * len(rows.blocks)
        with ThreadPoolExecutor(len(by_device)) as pool:
            futures = [
                (idx, pool.submit(issue, [rows.blocks[i] for i in idx],
                                  _issue_stream(device)))
                for device, idx in by_device.items()]
            for idx, future in futures:
                for i, out in zip(idx, future.result()):
                    done[i] = out
        return [o for o, _ in done], ns, n_real, [r for _, r in done]

    def scan_collect(self, dispatched) -> list[list[list[Peak]]]:
        """Read back a :meth:`scan_dispatch` result → peaks[episode][query].
        Waits for that scan only, not for scans dispatched after it; on a
        mesh, each shard after its own event."""
        with spans.span("collect", spans.group_of(dispatched)):
            outs, ns, n_real, ready = dispatched
            if not isinstance(ready, list):
                arrays = read_back(outs, ready)
            else:
                shards = [read_back(o, r) for o, r in zip(outs, ready)]
                arrays = [np.concatenate(parts) for parts in zip(*shards)]
            with spans.span("collect.peaks"):
                return self._peaks(arrays, ns, n_real)

    def scan_staged(
        self, staged, scale: bool = True
    ) -> list[list[list[Peak]]]:
        """Scan a :meth:`stage_resident` upload → peaks[episode][query]."""
        return self.scan_collect(self.scan_dispatch(staged, scale))

    def scan_resident(
        self, episodes: Sequence[np.ndarray], scale: bool = True, pad_to=None,
    ) -> list[list[list[Peak]]]:
        """Stage and scan a batch → peaks[episode][query]."""
        return self.scan_staged(self.stage_resident(episodes, pad_to), scale)


class ShardedScanner(_Scanner):
    """Scan groups of episodes against one or more query snippets on one
    device or a mesh of them: the batch scan of BASELINE config #3 at
    Q ≥ 2, and config #2 (one episode × one snippet) at Q = 1. Snippets are
    zero-padded to a common length; per-query valid ranges are masked on
    the device. ``scan_dispatch(staged, scale=False)`` leaves the
    correlations (and prominences) unscaled by the inverse
    autocorrelations.

    ``device``: the torch device that stages and scans (default the
    current CUDA device; ``"cpu"`` runs every kernel's plain version), a
    list of devices or a :class:`~.mesh.Mesh`; construction allocates
    nothing on them. ``query_state``: a prepared :class:`QueryState` to
    scan with instead of computing the spectra from ``snippets`` (copied
    to each device of a mesh). ``plain``: run every kernel's plain PyTorch
    version instead of the CUDA kernels (the reference path), eagerly.
    ``graphs``: see :class:`_Scanner`; the windows path :meth:`scan`
    replays each block's step too.
    """

    def __init__(
        self,
        snippets: Sequence[np.ndarray],
        sr: int,
        config: MatchConfig | None = None,
        device="cuda",
        query_state: QueryState | None = None,
        plain: bool = False,
        graphs: bool = True,
    ):
        super().__init__(device, graphs and not plain)
        self.sr = int(sr)
        self.config = cfg = config or MatchConfig()
        self.plain = bool(plain)
        preps = [prepare_snippet(s) for s in snippets]
        self.queries = [_Query(p.m, p.inv_autocorr) for p in preps]
        self.m_max = max(q.m for q in self.queries)
        self.m_min = min(q.m for q in self.queries)
        self.chunk = int(round(cfg.chunk_secs * self.sr))
        # +2: a peak on the exact hop boundary would otherwise sit on the
        # excluded edge column of both adjacent windows
        self.overlap = self.m_max + 2
        self.window = self.chunk + self.overlap
        self.valid = self.window - self.m_min + 1
        self.fft_len = fft_length(self.window + self.m_max - 1)
        self.fft_impl = resolve_fft_impl(cfg, self.fft_len)
        for d in self.devices:
            check_fft_len(self.fft_impl, self.fft_len, d)
        self.distance_samples = int(cfg.distance_secs) * self.sr
        self.n_peaks = min(
            self.valid // max(self.distance_samples, 1) + 2,
            cfg.max_peaks_per_chunk,
        )
        padded = np.zeros((len(preps), self.m_max), np.float32)
        for i, p in enumerate(preps):
            padded[i, : p.m] = p.data
        self._sample_padded = padded
        self._state = query_state
        self._states: dict = {}  # the query state copied to each device
        self._rfft_states: dict = {}  # the windows path's, the same

    def describe(self) -> str:
        """Which path the scan runs, for the log."""
        return describe_path(self.device, self.fft_impl,
                             self.config.peaks_impl, self.plain,
                             where=self._where())

    @property
    def query_state(self) -> QueryState:
        """The query-pair spectra of :attr:`fft_impl` and the per-query
        constants on the scan's device, computed on first use (the
        device's graphs giving way to them, see
        :func:`~.step_graph.releasing`)."""
        if self._state is None:
            self._state = releasing(self.device, self._query_spectra)
        return self._state

    def _query_spectra(self) -> QueryState:
        padded = torch.from_numpy(self._sample_padded).to(self.device)
        n = self.fft_len
        if self.fft_impl == "vpu":
            t_r, t_i = scrambled_query_spectra(padded, n, True)
        elif self.fft_impl == "mxu":
            t_r, t_i = scrambled_spectra_parts(padded, n)
        else:
            T = (packed_query_spectra(padded, n)
                 if self.fft_impl == "xla_packed"
                 else torch.fft.rfft(padded, n=n))
            t_r, t_i = T.real.contiguous(), T.imag.contiguous()
        return QueryState(t_r, t_i, *self._constants())

    def _constants(self):
        """The inverse autocorrelations [Q] f32 and the snippet lengths
        [Q] on the scan's (first) device."""
        return (
            torch.tensor([q.inv_autocorr for q in self.queries],
                         dtype=torch.float32, device=self.device),
            torch.tensor([q.m for q in self.queries], dtype=torch.int64,
                         device=self.device),
        )

    def _query_state_on(self, device: torch.device) -> QueryState:
        """:attr:`query_state`, computed once and copied to ``device``."""
        if device not in self._states:
            self._states[device] = self.query_state.to(device)
        return self._states[device]

    _prepare = _query_state_on

    def _width(self, n_max: int) -> int:
        return staged_width(self.config, self.chunk, self.overlap, n_max)

    def _scan(self, episodes_dev, ns, scale: bool, n_max: int):
        """Scan staged rows on their device; ``n_max``: the longest
        episode of the whole group, which sets the slab on every shard."""
        cfg = self.config
        dev = episodes_dev.device
        n_windows_pad = (episodes_dev.shape[1] - self.overlap) // self.chunk
        slab = scan_slab(cfg, self.chunk, n_max, n_windows_pad)
        static = (
            self.chunk, self.window, self.fft_len, self.valid,
            self.distance_samples, self.n_peaks, cfg.block, slab,
            n_windows_pad // slab, self.fft_impl, cfg.peaks_impl,
        )
        step = resident_match_step(*static, plain=self.plain)
        st = self._query_state_on(dev)
        inv_ac = st.inv_ac if scale else torch.ones_like(st.inv_ac)

        def run(episodes, ns_dev, inv, t_r, t_i, m):
            return step(episodes, ns_dev, t_r, t_i, inv, m)

        return run_step(self.step_graphs, ("resident",) + static, run,
                        (episodes_dev, device_ints(ns, dev), inv_ac),
                        (st.t_r, st.t_i, st.m))

    def _peaks(self, arrays, ns, n_real) -> list[list[list[Peak]]]:
        """Rebase each window's candidates and dedup across windows."""
        cfg = self.config
        pos, h, prom = arrays
        out = []
        for e in range(n_real):
            n_windows = max(-(-int(ns[e]) // self.chunk), 1)
            per_query = []
            for q in range(len(self.queries)):
                cands = []
                for k in range(min(n_windows, pos.shape[2])):
                    for s in range(pos.shape[3]):
                        if (
                            np.isfinite(h[e, q, k, s])
                            and prom[e, q, k, s] >= cfg.min_prominence
                        ):
                            cands.append(
                                Peak(
                                    int(pos[e, q, k, s]) + self.chunk * k,
                                    float(h[e, q, k, s]),
                                    float(prom[e, q, k, s]),
                                )
                            )
                per_query.append(
                    overshadow_filter(cands, self.sr, cfg.distance_secs)
                )
            out.append(per_query)
        return out

    # -- the legacy windows path (the JAX package's ``sharded_match_step``)

    def _rfft_state_on(self, device: torch.device) -> QueryState:
        """The queries' rfft spectra [Q, fft_len/2+1] (real and imaginary
        parts) and constants, computed once and copied to ``device``."""
        if not self._rfft_states:
            padded = torch.from_numpy(self._sample_padded).to(self.device)
            T = torch.fft.rfft(padded, n=self.fft_len)
            self._rfft_states[self.device] = QueryState(
                T.real.contiguous(), T.imag.contiguous(), *self._constants())
        if device not in self._rfft_states:
            self._rfft_states[device] = self._rfft_states[self.device].to(
                device)
        return self._rfft_states[device]

    def _windows(self, episodes: Sequence[np.ndarray], c_windows: int):
        """[E, c_windows, window] f32 overlap-save windows on the host and
        their raw lengths [E, c_windows] (the per-query crop is made on
        the device)."""
        E = len(episodes)
        buf = np.zeros((E, c_windows, self.window), np.float32)
        valid = np.zeros((E, c_windows), np.int32)
        for e, ep in enumerate(episodes):
            ep = np.asarray(ep, np.float32)
            for k in range(c_windows):
                win = ep[k * self.chunk : k * self.chunk + self.window]
                if len(win) == 0:
                    break
                buf[e, k, : len(win)] = win
                valid[e, k] = len(win)
        return buf, valid

    def _windows_step(self, windows, valid, scale: bool):
        """One block of windows [e, c, W] and lengths [e, c] on its
        device → (pos, h, prom), each [e, Q, c, S] (the JAX package's
        ``sharded_match_step``): rfft, the product with the conjugate query
        spectra, irfft cropped to the valid range, the scale, then the
        multi-pass picker per (episode, query, window). Replayed from
        :attr:`step_graphs` where there is one: the windows, lengths and
        scales are copied into the graph, the query spectra and lengths
        held."""
        st = self._rfft_state_on(windows.device)
        inv_ac = st.inv_ac if scale else torch.ones_like(st.inv_ac)
        fft_len, crop = self.fft_len, self.valid
        distance, n_peaks = self.distance_samples, self.n_peaks
        block = self.config.block

        def step(windows, valid, inv_ac, t_r, t_i, m):
            x = torch.fft.rfft(windows, n=fft_len)  # [e, c, F]
            spec = x[:, :, None, :] * torch.complex(t_r, -t_i)[None, None]
            c = torch.fft.irfft(spec, n=fft_len)[..., :crop]
            c = (c * inv_ac[None, None, :, None]).transpose(1, 2)
            vq = (valid[:, None, :] - m[None, :, None] + 1).clamp(min=0)
            picked = pick_peaks_core(c.reshape(-1, c.shape[-1]),
                                     vq.reshape(-1), distance, n_peaks,
                                     block)
            return tuple(a.reshape(*c.shape[:3], -1) for a in picked)

        return run_step(
            self.step_graphs,
            ("windows", fft_len, crop, distance, n_peaks, block), step,
            (windows, valid, inv_ac), (st.t_r, st.t_i, st.m))

    def scan(
        self, episodes: Sequence[np.ndarray], scale: bool = True
    ) -> list[list[list[Peak]]]:
        """→ peaks[episode][query], deduped and sorted: the legacy windows
        path, the JAX package's equivalence reference. Materializes the
        [E, C, W] f32 window tensor on the host (a warning above 1 GB;
        use :meth:`scan_resident` for batches that size), pads E to the
        mesh's ``data`` extent and C to its ``seq`` extent with silence,
        scans block (i, j) on ``mesh.devices[i][j]`` (torch ops, no
        kernel) and gathers the blocks on the host."""
        n_max = max(len(e) for e in episodes)
        C = max(-(-n_max // self.chunk), 1)
        host_bytes = len(episodes) * C * self.window * 4
        if host_bytes > 1 << 30:
            log.warning(
                "ShardedScanner.scan() materializes %.1f GB of host windows"
                " — use scan_resident() for batches this size",
                host_bytes / 2**30,
            )
        data, seq = self.mesh.shape
        E = len(episodes)
        E_pad = -(-E // data) * data
        eps = list(episodes) + [np.zeros(1, np.float32)] * (E_pad - E)
        C_pad = -(-C // seq) * seq
        windows, valid = self._windows(eps, C_pad)
        e_blk, c_blk = E_pad // data, C_pad // seq
        blocks = []
        for i, row in enumerate(self.mesh.devices):
            es = slice(i * e_blk, (i + 1) * e_blk)
            blocks.append([])
            for j, d in enumerate(row):
                cs = slice(j * c_blk, (j + 1) * c_blk)
                with _on(d):
                    blocks[-1].append(self._windows_step(
                        torch.from_numpy(
                            np.ascontiguousarray(windows[es, cs])).to(d),
                        torch.from_numpy(
                            np.ascontiguousarray(valid[es, cs])).to(d),
                        scale,
                    ))
        arrays = [
            np.concatenate([
                np.concatenate([blk[k].cpu().numpy() for blk in row], axis=2)
                for row in blocks
            ])
            for k in range(3)
        ]
        ns = np.array([len(e) for e in episodes], np.int64)
        return self._peaks(arrays, ns, E)


def spectrogram_pad_width(
    n_max: int, n_fft: int, max_waste: float = 0.25
) -> int:
    """Staged episode width of the spectrogram scanner, the JAX package's:
    the largest power-of-two quantum in [2^18, 2^22] whose padding stays
    under ``max_waste`` of the real samples, else the 2^18 floor (tiny
    episodes). Deterministic in (n_max, n_fft), so both packages frame
    and tile the same padded fingerprint."""
    n = max(int(n_max), int(n_fft))
    for b in (1 << 22, 1 << 21, 1 << 20, 1 << 19, 1 << 18):
        p = max(-(-n // b) * b, b)
        if p - n <= max_waste * n:
            return p
    return p  # the 2^18-quantum width: bounded absolute waste


def _row_scores(row, fb, fps, widths, n_fft: int, hop: int, t_ss: tuple):
    """One staged wire row [Npad] → its [Q, V] NCC scores (see
    :meth:`ShardedSpectrogramScanner.scores`)."""
    n_frames_pad = 1 + (row.shape[0] - n_fft) // hop
    fp = stft_log_mel_core(dequant_to_f32(row), fb, n_fft, hop, n_frames_pad)
    return ncc_frames_multi_core(fp, fps, t_ss, widths=widths)


def spectrogram_step(n_fft: int, hop: int, t_ss: tuple, distance: int,
                     n_peaks: int):
    """The spectrogram scan of a staged batch (the JAX package's
    spectrogram step). Returned fn: (episodes [E, Npad] wire, ns [E] int64
    on their device, fb, fps, widths (the scanner's filterbank, padded
    query fingerprints and their frame counts, int64)) → (pos, h, prom)
    each [E, Q, n_peaks], positions in frames. A Python loop over the
    rows that reads no host value from the device."""

    def step(episodes, ns, fb, fps, widths):
        per = []
        for e in range(episodes.shape[0]):
            scores = _row_scores(episodes[e], fb, fps, widths, n_fft, hop,
                                 t_ss)
            n_frames = (torch.div(ns[e] - n_fft, hop, rounding_mode="floor")
                        + 1).clamp(min=0)
            valid = (n_frames - widths + 1).clamp(min=0)
            per.append(pick_peaks_core(scores, valid, distance, n_peaks,
                                       2048))
        return tuple(torch.stack([p[i] for p in per]) for i in range(3))

    return step


class ShardedSpectrogramScanner(_Scanner):
    """Scan groups of episodes against query snippets in the spectrogram
    domain on one device or a mesh (BASELINE config #4 at archive scale;
    ``device`` as :class:`ShardedScanner`'s): each
    staged wire row is decoded on the device, reduced to its block-fused
    log-mel fingerprint, scored against every query by the overlap-save
    ZNCC that shares the episode's tile spectra, and its peaks are picked
    by the multi-pass picker (``ops.peaks.pick_peaks_core``). The same
    staging and ``scan_resident`` interface as :class:`ShardedScanner`, so
    the sweep (resume, prefetch, grouping, labels) is shared. Torch ops,
    no hand-written kernel.

    ``query_fps``: the padded [Q, t_max, n_mels] query fingerprints to
    scan with (e.g. the JAX scanner's ``_snip_fps``) instead of computing
    them from ``snippets``. NCC scores are scale-invariant: ``scale`` is
    accepted and ignored. ``graphs``: see :class:`_Scanner`.
    """

    def __init__(self, snippets, sr, config=None, device="cuda",
                 query_fps=None, graphs: bool = True):
        super().__init__(device, graphs)
        self.sr = int(sr)
        self.config = cfg = config or SpectrogramConfig()
        self._snippets = [np.asarray(s, np.float32) for s in snippets]
        self.t_ss = tuple(n_frames_of(len(s), cfg.n_fft, cfg.hop)
                          for s in self._snippets)
        self.distance_frames = cfg.frame_distance(self.sr)
        self._fb = torch.from_numpy(
            mel_filterbank(cfg.n_mels, cfg.n_fft, self.sr)).to(self.device)
        self._fps = None
        if query_fps is not None:
            self._fps = torch.from_numpy(
                np.asarray(query_fps, np.float32)).to(self.device)
        self._on_device: dict = {}  # (fb, fps, widths) on each device

    def describe(self) -> str:
        """Which path the scan runs, for the log."""
        return describe_spectrogram_path(self.device, where=self._where())

    @property
    def query_fps(self) -> torch.Tensor:
        """The padded [Q, t_max, n_mels] query fingerprints on the scan's
        (first) device, computed on first use."""
        if self._fps is None:
            cfg = self.config
            fps = torch.zeros((len(self.t_ss), max(self.t_ss), cfg.n_mels),
                              dtype=torch.float32, device=self.device)
            for q, s in enumerate(self._snippets):
                fps[q, : self.t_ss[q]] = log_mel(
                    s, self.sr, cfg.n_fft, cfg.hop, cfg.n_mels, fb=self._fb,
                    device=self.device)
            self._fps = fps
        return self._fps

    def _queries_on(self, device: torch.device):
        """The mel filterbank, :attr:`query_fps` and the queries' frame
        counts (int64), built once and copied to ``device``."""
        if device not in self._on_device:
            self._on_device[device] = (
                self._fb.to(device), self.query_fps.to(device),
                torch.tensor(self.t_ss, dtype=torch.int64, device=device))
        return self._on_device[device]

    _prepare = _queries_on

    def _width(self, n_max: int) -> int:
        return spectrogram_pad_width(n_max, self.config.n_fft)

    def scores(self, row: torch.Tensor) -> torch.Tensor:
        """One staged wire row [Npad] → its [Q, V] NCC scores against the
        queries, V = frames of the row − min(t_ss) + 1 (lags past a
        query's own valid range are not meaningful)."""
        cfg = self.config
        return _row_scores(row, *self._queries_on(row.device), cfg.n_fft,
                           cfg.hop, self.t_ss)

    def _scan(self, episodes_dev, ns, scale: bool, n_max: int):
        del scale, n_max  # NCC scores are scale-invariant; no slab
        cfg = self.config
        dev = episodes_dev.device
        n_frames_pad = 1 + (episodes_dev.shape[1] - cfg.n_fft) // cfg.hop
        n_peaks = min(
            (n_frames_pad - min(self.t_ss) + 1) // self.distance_frames + 2,
            64,
        )
        static = (cfg.n_fft, cfg.hop, self.t_ss, self.distance_frames,
                  n_peaks)
        return run_step(self.step_graphs, ("spectrogram",) + static,
                        spectrogram_step(*static),
                        (episodes_dev, device_ints(ns, dev)),
                        self._queries_on(dev))

    def _peaks(self, arrays, ns, n_real) -> list[list[list[Peak]]]:
        """Finite heights ≥ ``min_score``, positions in samples, sorted."""
        cfg = self.config
        pos, h, prom = arrays
        out = []
        for e in range(n_real):
            per_query = []
            for q in range(len(self.t_ss)):
                peaks = [
                    Peak(int(pos[e, q, s]) * cfg.hop, float(h[e, q, s]),
                         float(prom[e, q, s]))
                    for s in range(pos.shape[2])
                    if np.isfinite(h[e, q, s]) and h[e, q, s] >= cfg.min_score
                ]
                peaks.sort(key=lambda p: p.position)
                per_query.append(peaks)
            out.append(per_query)
        return out


def sweep_archive(
    paths,
    snippets: Sequence[np.ndarray],
    sr: int,
    config: MatchConfig | None = None,
    device=None,
    progress_path=None,
    write_labels_for=None,
    prefetch_depth: int | None = None,
    resample_mismatched: bool = False,
    mode: str = "pcm",
    spectrogram_config: SpectrogramConfig | None = None,
    group_size: int | None = None,
):
    """Scan an archive of files against query snippets, with resume
    (BASELINE config #5).

    ``device``: one device, a list or a :class:`~.mesh.Mesh` (default the
    current CUDA device; in a cluster joined by ``mesh.init_distributed``,
    this process's :func:`~.mesh.make_local_mesh`). In a cluster every
    process takes every ``process_count()``-th file of ``paths`` from its
    ``process_index()``, then skips those already Done: it returns,
    labels and marks Done only its own share.

    Files decode ahead of the scan on worker threads, straight to the
    staging wire (``hostio.prefetch``); groups of ``group_size`` episodes
    (default the mesh's size, or 8 on one device; an explicit size is
    rounded up to a multiple of the mesh's) stage exactly their decoded
    rows and scan on the device or over the mesh.
    Group N is collected only after group N+1 has been staged and its scan
    queued, so on a CUDA device the next group's decode, packing and
    upload overlap the current group's scan. A file is marked
    Done in the ``.done.txt`` store at ``progress_path`` once its peaks
    are collected and passed to ``write_labels_for(path, query, peaks)``,
    so an interrupted sweep resumes after the last collected file; files
    already Done are skipped. Files that fail to decode, and files at
    another sample rate unless ``resample_mismatched``, are logged and
    skipped. ``AUDIO_MATCHER_GROUP_BYTES`` (default 1 GiB) bounds a
    group's padded staging buffer and the prefetch queue.
    ``mode="spectrogram"`` scans log-mel fingerprints
    (:class:`ShardedSpectrogramScanner` under ``spectrogram_config``, whose
    transfer dtype and resampler then apply) on the same machinery.
    Files at another rate resample by the config's ``resample_impl``,
    ``"auto"`` resolving from the device (on the card for a CUDA device),
    on the mesh's first device. Returns {path: [peaks per query]}.
    """
    from ..hostio.decode import resample, resolve_resample_impl
    from ..hostio.prefetch import decode_prefetched
    from ..meta.progress import Progress, State

    n_proc = process_count()
    if device is None:
        device = make_local_mesh() if n_proc > 1 else "cuda"
    if mode == "spectrogram":
        scanner = ShardedSpectrogramScanner(snippets, sr, spectrogram_config,
                                            device=device)
    elif mode == "pcm":
        scanner = ShardedScanner(snippets, sr, config, device=device)
    else:
        raise ValueError(f"mode={mode!r}: expected 'pcm' or 'spectrogram'")
    log.info("sweep: %s", scanner.describe())
    resample_impl = resolve_resample_impl(scanner.config.resample_impl,
                                          scanner.device)
    if resample_mismatched:
        log.info("sweep: files at another rate resample by %s",
                 resample_impl)
    progress = Progress(progress_path) if progress_path is not None else None
    # the share is fixed by the path list alone, before the resume filter,
    # so each process resumes exactly the files it owns
    todo = [p for p in list(paths)[process_index()::n_proc]
            if progress is None or progress.get(str(p)) != State.DONE]
    n_dev = len(scanner.devices)
    if group_size is None:
        group_size = n_dev if n_dev > 1 else 8
    else:
        group_size = max(-(-int(group_size) // n_dev) * n_dev, n_dev)
    if prefetch_depth is None:
        prefetch_depth = max(group_size, 3)  # the next group, decoded
    transfer = scanner.config.transfer_dtype
    results = {}
    pending: list = []  # at most one (dispatched, ok_items)

    def emit(dispatched, ok_items):
        peaks = scanner.scan_collect(dispatched)
        for item, per_query in zip(ok_items, peaks):
            results[str(item.path)] = per_query
            if write_labels_for is not None:
                for q, pk in enumerate(per_query):
                    write_labels_for(item.path, q, pk)
            if progress is not None:
                progress.append(str(item.path), State.DONE)

    def flush(group):
        episodes, ok_items = [], []
        for item in group:
            if item.error is not None:
                log.error("skipping %s: %s", item.path, item.error)
                continue
            samples = item.samples
            if item.sr != scanner.sr:
                if not resample_mismatched:
                    log.error(
                        "skipping %s: sample rate %s != %s "
                        "(pass --resample to convert)",
                        item.path, item.sr, scanner.sr,
                    )
                    continue
                # the int16 wire only where staging quantizes anyway: a
                # float32 sweep keeps f32 samples end to end
                samples = resample(
                    samples, item.sr, scanner.sr, impl=resample_impl,
                    wire_int16=transfer != "float32", device=scanner.device,
                )
            ok_items.append(item)
            episodes.append(samples)
        if not episodes:
            return
        dispatched = scanner.scan_dispatch(scanner.stage_resident(episodes))
        if pending:
            emit(*pending.pop())
        pending.append((dispatched, ok_items))

    # the budget is judged on the PADDED staging buffer (every row is
    # padded to the group's longest episode), so long episodes go fewer
    # per group and a long one after short ones flushes the shorts first
    max_group_bytes = int(
        os.environ.get("AUDIO_MATCHER_GROUP_BYTES", str(1 << 30))
    )
    group: list = []
    row_max = 0  # the widest episode of the current group, wire bytes
    for decoded in decode_prefetched(
        todo, depth=prefetch_depth, wire_dtype=transfer,
        expect_sr=scanner.sr, max_bytes=max_group_bytes,
    ):
        new_max = max(row_max, decoded.samples.nbytes)
        if group and (len(group) + 1) * new_max > max_group_bytes:
            flush(group)
            group, new_max = [], decoded.samples.nbytes
        group.append(decoded)
        row_max = new_max
        if len(group) == group_size:
            flush(group)
            group, row_max = [], 0
        elif len(group) * row_max >= max_group_bytes:
            flush(group)
            group, row_max = [], 0
    if group:
        flush(group)
    if pending:  # drain the one-group-deep pipeline
        emit(*pending.pop())
    if scanner.step_graphs is not None:
        log.info("sweep: step graphs %s", dict(scanner.step_graphs.stats))
    return results
