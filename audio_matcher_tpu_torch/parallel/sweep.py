"""The resident batch scan on one device (port of ``parallel/sweep.py``).

BASELINE config #3: a group of episodes is staged once as a flat
[E, Npad] wire-dtype tensor; overlap-save windows are strided views of it;
every window's forward FFT is shared across all Q query snippets, and the
query pairs pack into the inverse transforms. Per slab of windows:

    windows (wire) → corr_slab_vpu_planes_wire → pick_peaks_packed

and on the host, :meth:`ShardedScanner.scan_collect` rebases positions and
dedups across windows with ``overshadow_filter``.

Only the JAX package's fused path (``fft_impl="vpu"``,
``peaks_impl="pallas"``, Q ≥ 2, ``fft_len`` ≥ 2^14, one device) is ported;
the scanner refuses anything else with :class:`NotImplementedError`
naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..models.matcher import (
    TORCH_WIRE_DTYPES,
    WIRE_DTYPES,
    MatchConfig,
    divisor_slab,
    effective_slab,
    overshadow_filter,
    pad_wire_on_device,
    quantize_wire,
    window_rows,
    windows_from_episode,
    wire_silence,
)
from ..ops.correlate import fft_length, prepare_snippet
from ..ops.cuda_fft import (
    MIN_N,
    corr_slab_vpu_planes_wire,
    round_planes_width,
    scrambled_query_spectra,
)
from ..ops.peaks import Peak, peaks_crop_width, pick_peaks_packed


@dataclasses.dataclass
class _Query:
    m: int
    inv_autocorr: float


@dataclasses.dataclass(frozen=True)
class QueryState:
    """What the scan holds of its queries (this system's weights): the
    scrambled query-pair spectra (``scrambled_query_spectra(pack=True)``,
    [Qh, n] f32 each), the inverse autocorrelations [Q] f32 and the
    snippet lengths [Q]."""

    t_r: torch.Tensor
    t_i: torch.Tensor
    inv_ac: torch.Tensor
    m: torch.Tensor


def query_state_from_numpy(t_r, t_i, inv_ac, m, device) -> QueryState:
    """Carry a prepared query state across (e.g. the JAX scanner's
    ``_sample_f_resident``, ``_inv_ac`` and ``_m`` as numpy arrays), so
    that both packages scan with identical spectra."""
    dev = torch.device(device)
    return QueryState(
        t_r=torch.tensor(np.asarray(t_r, np.float32), device=dev),
        t_i=torch.tensor(np.asarray(t_i, np.float32), device=dev),
        inv_ac=torch.tensor(np.asarray(inv_ac, np.float32), device=dev),
        m=torch.tensor(np.asarray(m, np.int64), device=dev),
    )


def _fill_wire_rows(episodes, n_pad: int, transfer: str, out: np.ndarray):
    """Pack episodes into the [rows, n_pad] wire-dtype buffer ``out``;
    rows past the episodes and every tail are wire silence. Rows already
    in the wire dtype are copied; others quantize here."""
    dtype = WIRE_DTYPES[transfer]
    out.fill(wire_silence(transfer))
    for i, ep in enumerate(episodes):
        ep = np.asarray(ep)
        if len(ep) > n_pad:
            raise ValueError(f"episode {i} is longer than the staged width")
        out[i, : len(ep)] = ep if ep.dtype == dtype else quantize_wire(
            ep, transfer
        )
    return out


def _stage_rows_host(episodes, ns, n_pad, transfer, e_pad, device):
    """Fill a (pinned, for a CUDA device) host buffer with the wire rows
    and upload it with one copy. Returns the staged triple
    (tensor [e_pad, n_pad], ns_pad, n_real)."""
    ns_pad = np.zeros(e_pad, np.int32)
    ns_pad[: len(ns)] = ns
    host = torch.empty(
        (e_pad, n_pad), dtype=TORCH_WIRE_DTYPES[transfer],
        pin_memory=device.type == "cuda",
    )
    _fill_wire_rows(episodes, n_pad, transfer, host.numpy())
    staged = host if device.type == "cpu" else host.to(
        device, non_blocking=True
    )
    return staged, ns_pad, len(episodes)


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
    plain: bool = False,
):
    """The resident multi-query scan of a staged batch.

    Returned fn: (episodes [E, Npad] wire, ns [E] host ints, t_r, t_i
    [Qh, n], inv_ac [Q], m [Q]) → (pos, h, prom) each
    [E, Q, n_slabs·slab, S]. Episodes and slabs run in a Python loop that
    reuses one slab's intermediate planes. ``plain=True`` runs every
    kernel's plain PyTorch version instead (the reference path).
    """
    crop = round_planes_width(
        min(peaks_crop_width(valid_max, block), fft_len), fft_len
    )
    target = (n_slabs * slab + window_rows(window, chunk)) * chunk

    def per_episode(episode, n: int, t_r, t_i, inv_ac, m, work: dict):
        dev = episode.device
        episode = pad_wire_on_device(episode, target)
        Q = inv_ac.shape[0]
        Q2 = 2 * t_r.shape[0]  # queries incl. the odd-Q pad
        inv_pad = torch.nn.functional.pad(inv_ac, (0, Q2 - Q))
        m_pad = torch.nn.functional.pad(m, (0, Q2 - Q), value=1)
        scale = inv_pad.repeat(slab)  # logical rows: q fastest
        outs = []
        for s in range(n_slabs):
            base = s * slab
            starts = (base + torch.arange(slab, device=dev)) * chunk
            windows = windows_from_episode(episode, base, slab, chunk, window)
            win_len = (n - starts).clamp(0, window)
            yr, yi = corr_slab_vpu_planes_wire(
                windows, t_r, t_i, crop, plain=plain, work=work
            )
            vq2 = (win_len[:, None] - m_pad[None, :] + 1).clamp(min=0)
            vq2[:, Q:] = 0  # the pad query emits nothing
            picked = pick_peaks_packed(
                yr, yi, scale, vq2.reshape(-1), distance, n_peaks, block,
                plain=plain,
            )
            outs.append(
                [a.reshape(slab, Q2, -1)[:, :Q].transpose(0, 1)
                 for a in picked]
            )  # [Q, B, S] triplets
        return [torch.cat([o[i] for o in outs], dim=1) for i in range(3)]

    def step(episodes, ns, t_r, t_i, inv_ac, m):
        work: dict = {}
        per = [
            per_episode(episodes[e], int(ns[e]), t_r, t_i, inv_ac, m, work)
            for e in range(episodes.shape[0])
        ]
        return tuple(torch.stack([p[i] for p in per]) for i in range(3))

    return step


class ShardedScanner:
    """Scan groups of episodes against two or more query snippets on one
    device (BASELINE config #3: the batch scan). Snippets are zero-padded
    to a common length; per-query valid ranges are masked on the device.

    ``device``: the torch device that stages and scans. ``query_state``:
    a prepared :class:`QueryState` to scan with instead of computing the
    spectra from ``snippets``. ``plain``: run every kernel's plain PyTorch
    version instead of the CUDA kernels (the reference path).
    """

    def __init__(
        self,
        snippets: Sequence[np.ndarray],
        sr: int,
        config: MatchConfig | None = None,
        device="cpu",
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
        if cfg.fft_impl != "vpu" or cfg.peaks_impl != "pallas":
            raise NotImplementedError(
                f"fft_impl={cfg.fft_impl!r}, peaks_impl={cfg.peaks_impl!r}: "
                "only 'vpu' + 'pallas' is ported (other branches: ROADMAP P3)"
            )
        preps = [prepare_snippet(s) for s in snippets]
        if len(preps) < 2:
            raise NotImplementedError(
                "the single-query scan (Q = 1) is ROADMAP P2"
            )
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
        if self.fft_len < MIN_N:
            raise NotImplementedError(
                f"fft_len {self.fft_len} < {MIN_N}: the JAX package "
                "switches to 'xla_packed' there (ROADMAP P3)"
            )
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
        """The scrambled query-pair spectra and per-query constants on the
        scan's device, computed on first use."""
        if self._state is None:
            t_r, t_i = scrambled_query_spectra(
                torch.from_numpy(self._sample_padded).to(self.device),
                self.fft_len, True,
            )
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
        n_windows = max(-(-n_max // self.chunk), 1)
        slab = effective_slab(self.config, n_windows)
        n_windows_pad = -(-n_windows // slab) * slab
        n_pad = n_windows_pad * self.chunk + self.overlap
        e_pad = max(len(episodes), int(pad_to or 0))
        return _stage_rows_host(
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
        slab = effective_slab(cfg, max(-(-n_max // self.chunk), 1))
        if n_windows_pad % slab:  # buffer staged under a different policy
            slab = divisor_slab(n_windows_pad, cfg.slab)
        step = resident_match_step(
            self.chunk, self.window, self.fft_len, self.valid,
            self.distance_samples, self.n_peaks, cfg.block, slab,
            n_windows_pad // slab, plain=self.plain,
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
