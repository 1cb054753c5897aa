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
dedups across windows with ``overshadow_filter``. More than one device
raises :class:`NotImplementedError` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..models.matcher import (
    MatchConfig,
    check_fft_len,
    correlation_crop,
    is_fused,
    overshadow_filter,
    pad_wire_on_device,
    resolve_fft_impl,
    scan_slab,
    single_query_slab,
    stage_rows_host,
    staged_width,
    window_rows,
    windows_from_episode,
)
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
from ..ops.peaks import Peak, pick_peaks_dispatch, pick_peaks_packed
from ..ops.wire import dequant_to_f32


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

    Returned fn: (episodes [E, Npad] wire, ns [E] host ints, t_r, t_i
    (:class:`QueryState`'s spectra), inv_ac [Q], m [Q]) → (pos, h, prom)
    each [E, Q, n_slabs·slab, S]. Episodes and slabs run in a Python loop
    that reuses one slab's intermediate planes. ``plain=True`` runs every
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

    def per_episode(episode, n: int, slab_fn, spectra, inv_ac, m, work):
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
        work: dict = {}
        per = [
            per_episode(episodes[e], int(ns[e]), slab_fn, spectra, inv_ac, m,
                        work)
            for e in range(episodes.shape[0])
        ]
        return tuple(torch.stack([p[i] for p in per]) for i in range(3))

    return step


class ShardedScanner:
    """Scan groups of episodes against one or more query snippets on one
    device: the batch scan of BASELINE config #3 at Q ≥ 2, and config #2
    (one episode × one snippet) at Q = 1. Snippets are zero-padded to a
    common length; per-query valid ranges are masked on the device.

    ``device``: the torch device that stages and scans (default the
    current CUDA device; ``"cpu"`` runs every kernel's plain version);
    construction allocates nothing on it. ``query_state``: a prepared
    :class:`QueryState` to scan with instead of computing the spectra from
    ``snippets``. ``plain``: run every kernel's plain PyTorch version
    instead of the CUDA kernels (the reference path).
    """

    def __init__(
        self,
        snippets: Sequence[np.ndarray],
        sr: int,
        config: MatchConfig | None = None,
        device="cuda",
        query_state: QueryState | None = None,
        plain: bool = False,
    ):
        if isinstance(device, (list, tuple)):
            if len(device) != 1:
                raise NotImplementedError(
                    "scanning over several devices is ROADMAP P7"
                )
            device = device[0]
        self.device = torch.device(device)
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
        check_fft_len(self.fft_impl, self.fft_len, self.device)
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

    @property
    def query_state(self) -> QueryState:
        """The query-pair spectra of :attr:`fft_impl` and the per-query
        constants on the scan's device, computed on first use."""
        if self._state is None:
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
            self._state = QueryState(
                t_r=t_r,
                t_i=t_i,
                inv_ac=torch.tensor(
                    [q.inv_autocorr for q in self.queries],
                    dtype=torch.float32, device=self.device,
                ),
                m=torch.tensor(
                    [q.m for q in self.queries], dtype=torch.int64,
                    device=self.device,
                ),
            )
        return self._state

    def stage_resident(self, episodes: Sequence[np.ndarray], pad_to=None):
        """Pack the batch into one [E, Npad] wire-dtype host buffer
        (pinned for a CUDA device) and upload it with one copy.
        ``pad_to``: minimum episode count (silence rows)."""
        ns = np.array([len(e) for e in episodes], np.int32)
        n_max = int(ns.max()) if len(ns) else 0
        n_pad = staged_width(self.config, self.chunk, self.overlap, n_max)
        e_pad = max(len(episodes), int(pad_to or 0))
        return stage_rows_host(
            episodes, ns, n_pad, self.config.transfer_dtype, e_pad,
            self.device,
        )

    def scan_dispatch(self, staged):
        """Run the scan of a :meth:`stage_resident` upload; the returned
        device tensors may still be in flight."""
        episodes_dev, ns, n_real = staged
        cfg = self.config
        n_windows_pad = (episodes_dev.shape[1] - self.overlap) // self.chunk
        n_max = int(ns.max()) if len(ns) else 0
        slab = scan_slab(cfg, self.chunk, n_max, n_windows_pad)
        step = resident_match_step(
            self.chunk, self.window, self.fft_len, self.valid,
            self.distance_samples, self.n_peaks, cfg.block, slab,
            n_windows_pad // slab, self.fft_impl, cfg.peaks_impl,
            plain=self.plain,
        )
        st = self.query_state
        outs = step(episodes_dev, ns, st.t_r, st.t_i, st.inv_ac, st.m)
        return outs, ns, n_real

    def scan_collect(self, dispatched) -> list[list[list[Peak]]]:
        """Read back a :meth:`scan_dispatch` result → peaks[episode][query]."""
        (pos, h, prom), ns, n_real = dispatched
        cfg = self.config
        pos, h, prom = (a.cpu().numpy() for a in (pos, h, prom))
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

    def scan_staged(self, staged) -> list[list[list[Peak]]]:
        """Scan a :meth:`stage_resident` upload → peaks[episode][query]."""
        return self.scan_collect(self.scan_dispatch(staged))

    def scan_resident(
        self, episodes: Sequence[np.ndarray], pad_to=None
    ) -> list[list[list[Peak]]]:
        """Stage and scan a batch → peaks[episode][query]."""
        return self.scan_staged(self.stage_resident(episodes, pad_to))
