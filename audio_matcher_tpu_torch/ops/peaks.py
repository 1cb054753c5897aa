"""Peak picking over correlation rows (port of ``ops/peaks.py``): the
single-read paths over the pair-packed planes of the two-factor FFT
(:func:`pick_peaks_packed`) and over a dense [B, V] correlation
(:func:`pick_peaks_dense`), both ``peaks_impl="pallas"``; the multi-pass
picker of ``peaks_impl="jnp"`` (:func:`pick_peaks_core`, plain torch over
the whole rows); and :func:`find_peaks_device` for one signal.

Semantics (scipy ``find_peaks(distance=, prominence=)`` as the reference
uses it, per window):

  * local maxima are strict: a plateau is never a peak;
  * min distance is scipy's greedy-by-height suppression, as repeated
    masked argmax (ties keep the lowest position);
  * prominence is topographic, from block minima/maxima pyramids and small
    gathers around each pick.

The single-read paths read the rows once, by
:func:`local_max_block_reduce_packed` or :func:`local_max_block_reduce`;
every later stage (seam repair, ``n_peaks`` suppression rounds with an
exact rescan of the partly suppressed edge tiles, prominence) works on the
[rows, NB] block arrays and on gathers of a few tiles. On CUDA rows (and
``plain=False``) one kernel runs those stages for the whole slab
(``cuda_kernels.peak_rounds``); on CPU rows, or with ``plain=True``, their
plain version :func:`_peak_rounds_plain` runs them as torch ops, as the
JAX package runs them as plain ``jnp``. The whole ``"jnp"`` picker is
plain torch ops on the rows' device. Both pickers give bit-identical
results on the same rows (exhausted slots apart: their positions are the
picker's own).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from .cuda_kernels import (
    GROUP,
    local_max_block_reduce,
    local_max_block_reduce_packed,
    local_max_block_reduce_packed_plain,
    local_max_block_reduce_plain,
    peak_rounds,
)

_NEG = float("-inf")
_POS = float("inf")
_SENTINEL = -(1 << 30)  # a picked slot that excludes nothing


@dataclasses.dataclass(frozen=True)
class Peak:
    """A match peak. ``position`` is the sample where the snippet starts."""

    position: int
    height: float
    prominence: float

    def start_secs(self, sr: int) -> float:
        return self.position / sr


def _interleave_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[P, ...] even rows + [P, ...] odd rows → [2P, ...]."""
    return torch.stack([a, b], dim=1).reshape(-1, *a.shape[1:])


def _gather_rows(x: torch.Tensor, starts: torch.Tensor, width: int):
    """Row r of ``x`` at columns ``starts[r, ...] + [0, width)`` →
    [rows, ..., width]; starts clamp so the slice fits, as
    ``lax.dynamic_slice`` does."""
    starts = starts.clamp(0, max(x.shape[1] - width, 0))
    offs = torch.arange(width, device=starts.device)
    idx = (starts[..., None] + offs).reshape(starts.shape[0], -1)
    return torch.gather(x, 1, idx).reshape(*starts.shape, width)


class _DenseRows:
    """Row source over a materialized [B, V] f32 correlation. ``plain``
    selects the reduction's plain version on any device."""

    def __init__(self, x, plain: bool = False):
        self.x = x
        self.shape = tuple(x.shape)
        self.plain = plain

    def columns(self, p: torch.Tensor) -> torch.Tensor:  # [K] → [B, K]
        return self.x[:, p]

    def slices(self, starts, width: int):  # [B, ...] → [B, ..., width]
        return _gather_rows(self.x, starts, width)

    slice_slots = slices  # [B, S] starts: one gather serves both shapes

    def block_reduce(self, valid_len, block: int):
        reduce = (
            local_max_block_reduce_plain if self.plain
            else local_max_block_reduce
        )
        return reduce(self.x, valid_len, block)

    def peak_rounds(self, valid_len, reduced, distance, n_peaks, block):
        return peak_rounds((self.x,), None, valid_len, reduced, distance,
                           n_peaks, block)


class _PackedPairRows:
    """Row source over the pair-packed planes: logical row 2p is
    ``yr[p]·scale[2p]``, row 2p+1 is ``yi[p]·scale[2p+1]``. Only gathers of
    a few columns are ever materialized. ``plain`` selects the reduction's
    plain version on any device."""

    def __init__(self, yr, yi, scale, plain: bool = False):
        if yr.shape != yi.shape:
            raise ValueError("yr and yi must have one shape")
        self.yr = yr
        self.yi = yi
        self.scale = scale.to(torch.float32).contiguous()  # [2P]
        self.shape = (2 * yr.shape[0], yr.shape[1])
        self.plain = plain

    def columns(self, p: torch.Tensor) -> torch.Tensor:  # [K] → [2P, K]
        x = _interleave_rows(self.yr[:, p], self.yi[:, p])
        return x * self.scale[:, None]

    def _gather(self, starts: torch.Tensor, width: int) -> torch.Tensor:
        """[2P, ...] starts → [2P, ..., width]."""
        return _interleave_rows(
            _gather_rows(self.yr, starts[0::2], width),
            _gather_rows(self.yi, starts[1::2], width),
        )

    def slices(self, starts, width: int):  # [2P] → [2P, width]
        return self._gather(starts, width) * self.scale[:, None]

    def slice_slots(self, starts, width: int):  # [2P, S] → [2P, S, width]
        return self._gather(starts, width) * self.scale[:, None, None]

    def block_reduce(self, valid_len, block: int):
        reduce = (
            local_max_block_reduce_packed_plain if self.plain
            else local_max_block_reduce_packed
        )
        return reduce(
            self.yr, self.yi, self.scale, valid_len, block
        )

    def peak_rounds(self, valid_len, reduced, distance, n_peaks, block):
        return peak_rounds((self.yr, self.yi), self.scale, valid_len,
                           reduced, distance, n_peaks, block)


def _merge_seams(src, valid_len, bv, bp, block: int):
    """Fold segment-boundary local maxima into the per-tile candidates:
    the reduction leaves the two columns at each ``GROUP``-tile boundary
    blind. Ties keep the earlier position: the last column of a tile wins
    only when strictly higher, the first column also on equality."""
    B, V = src.shape
    NB = V // block
    if NB <= GROUP:
        return bv, bp
    dev = bv.device
    js = torch.arange(GROUP, NB, GROUP, device=dev)
    vl = valid_len[:, None]
    for offs, strict in ((-1, True), (0, False)):
        p = js * block + offs
        x0 = src.columns(p)
        pk = (x0 > src.columns(p - 1)) & (x0 > src.columns(p + 1))
        pk &= (p[None, :] >= 1) & (p[None, :] <= vl - 2)
        h = torch.where(pk, x0, _NEG)
        tiles = torch.div(p, block, rounding_mode="floor")
        cur = bv[:, tiles]
        upd = (h > cur) if strict else (h >= cur) & torch.isfinite(h)
        bv[:, tiles] = torch.where(upd, h, cur)
        bp[:, tiles] = torch.where(upd, p[None, :].to(bp.dtype), bp[:, tiles])
    return bv, bp


def _rescan_tile(src, valid_len, picked, tile, d: int, block: int):
    """Best surviving local max of one tile per row, excluding every picked
    interval |col − p_j| < d (sentinel slots exclude nothing)."""
    B, V = src.shape
    dev = tile.device
    t = tile.clamp(0, V // block - 1)
    start = t * block
    width = min(block + 2, V)
    p0 = (start - 1).clamp(0, max(V - width, 0))
    win = src.slices(p0, width)
    cols = p0[:, None] + 1 + torch.arange(width - 2, device=dev)[None, :]
    c = win[:, 1:-1]
    in_tile = (cols >= start[:, None]) & (cols < start[:, None] + block)
    interior = (cols >= 1) & (cols <= valid_len[:, None] - 2)
    pk = (c > win[:, :-2]) & (c > win[:, 2:]) & interior & in_tile
    excl = ((cols[:, None, :] - picked[:, :, None]).abs() < d).any(dim=1)
    h = torch.where(pk & ~excl, c, _NEG)
    best = h.argmax(dim=1)
    bi = torch.arange(B, device=dev)
    return h[bi, best], cols[bi, best]


def _prominences_from_blocks(gather_blocks, block_min, block_max, pos, h,
                             block: int):
    """Prominence from a block pyramid: the nearest strictly higher sample
    on each side (first inside the peak's own block, then the nearest
    block holding one), and the minimum over the spanned range."""
    NB = block_min.shape[1]
    dev = pos.device
    pb = torch.div(pos, block, rounding_mode="floor")  # [B, S]
    r = pos % block
    own_min, own_max = gather_blocks(pb)  # [B, S, block]
    bcols = torch.arange(block, device=dev)[None, None, :]
    bidx = torch.arange(NB, device=dev)[None, None, :]
    hx = h[..., None]
    bmin3 = block_min[:, None, :]
    bmax3 = block_max[:, None, :]

    def masked(mask, v, fill, take_max: bool):
        w = torch.where(mask, v, fill)
        return w.amax(-1) if take_max else w.amin(-1)

    def side(left: bool):
        if left:
            in_sel, blk_sel = bcols < r[..., None], bidx < pb[..., None]
            in_fill, blk_fill = -1, -1
        else:
            in_sel, blk_sel = bcols > r[..., None], bidx > pb[..., None]
            in_fill, blk_fill = block, NB
        in_mask = in_sel & (own_max > hx)
        found_in = in_mask.any(-1)
        j_in = masked(in_mask, bcols, in_fill, left)
        blk_mask = blk_sel & (bmax3 > hx)
        found_blk = blk_mask.any(-1)
        j_blk = masked(blk_mask, bidx, blk_fill, left)
        far_min, far_max = gather_blocks(j_blk.clamp(0, NB - 1))
        j_far = masked(far_max > hx, bcols, in_fill, left)
        jin, jfar, jblk = j_in[..., None], j_far[..., None], j_blk[..., None]
        rr, pbb = r[..., None], pb[..., None]
        if left:
            minA = masked((bcols > jin) & (bcols <= rr), own_min, _POS, False)
            part_far = masked(bcols > jfar, far_min, _POS, False)
            between = (bidx > jblk) & (bidx < pbb)
            part_own = masked(bcols <= rr, own_min, _POS, False)
            edge_mid = masked(bidx < pbb, bmin3, _POS, False)
        else:
            minA = masked((bcols < jin) & (bcols >= rr), own_min, _POS, False)
            part_far = masked(bcols < jfar, far_min, _POS, False)
            between = (bidx < jblk) & (bidx > pbb)
            part_own = masked(bcols >= rr, own_min, _POS, False)
            edge_mid = masked(bidx > pbb, bmin3, _POS, False)
        part_mid = masked(between, bmin3, _POS, False)
        minB = torch.minimum(torch.minimum(part_far, part_mid), part_own)
        minC = torch.minimum(edge_mid, part_own)
        return torch.where(found_in, minA, torch.where(found_blk, minB, minC))

    return h - torch.maximum(side(True), side(False))


def _pick_peaks_from_source(src, valid_len, distance: int, n_peaks: int,
                            block: int):
    """The reduction, then the rounds: on CUDA rows with ``src.plain``
    False the kernel's (one launch), else :func:`_peak_rounds_plain`."""
    reduced = src.block_reduce(valid_len, block)
    if reduced[0].is_cuda and not src.plain:
        return src.peak_rounds(valid_len, reduced, distance, n_peaks, block)
    return _peak_rounds_plain(src, valid_len, reduced, distance, n_peaks,
                              block)


def _peak_rounds_plain(src, valid_len, reduced, distance: int, n_peaks: int,
                       block: int):
    """Plain version of ``cuda_kernels.peak_rounds`` on a row source and
    its reduction ``reduced`` (whose candidates it overwrites): the seam
    merge, ``n_peaks`` suppression rounds, the prominences. Returns (pos
    int32, height, prominence), each [rows, n_peaks]."""
    B, V = src.shape
    NB = V // block
    dev = valid_len.device
    valid_len = valid_len.to(torch.int64)
    bv, bp, bmin, bmax = reduced
    bp = bp.to(torch.int64)
    bv, bp = _merge_seams(src, valid_len, bv, bp, block)

    d = max(int(distance), 1)
    tile_start = torch.arange(NB, device=dev)[None, :] * block
    tile_end = tile_start + block - 1
    bi = torch.arange(B, device=dev)
    picked = torch.full((B, n_peaks), _SENTINEL, dtype=torch.int64, device=dev)
    pos_out, h_out = [], []
    for r in range(n_peaks):
        k = bv.argmax(dim=1)
        h = bv[bi, k]
        pos = bp[bi, k]
        real = torch.isfinite(h)
        picked[:, r] = torch.where(real, pos, _SENTINEL)
        lo = pos - d + 1
        hi = pos + d - 1
        full = (
            (tile_start >= lo[:, None]) & (tile_end <= hi[:, None])
            & real[:, None]
        )
        bv = torch.where(full, _NEG, bv)
        for edge in (torch.div(lo, block, rounding_mode="floor"),
                     torch.div(hi, block, rounding_mode="floor")):
            in_range = (edge >= 0) & (edge < NB) & real
            nv, npos = _rescan_tile(src, valid_len, picked, edge, d, block)
            t = edge.clamp(0, NB - 1)
            bv[bi, t] = torch.where(in_range, nv, bv[bi, t])
            bp[bi, t] = torch.where(in_range, npos, bp[bi, t])
        pos_out.append(pos)
        h_out.append(h)
    pos = torch.stack(pos_out, dim=1)  # [B, S]
    height = torch.stack(h_out, dim=1)
    cols = torch.arange(block, device=dev)

    def gather_blocks(pb):
        starts = pb.clamp(0, NB - 1) * block  # [B, S]
        seg = src.slice_slots(starts, block)  # [B, S, block]
        cv = (starts[..., None] + cols) < valid_len[:, None, None]
        return torch.where(cv, seg, _POS), torch.where(cv, seg, _NEG)

    prom = _prominences_from_blocks(
        gather_blocks, bmin, bmax, pos.clamp(min=0), height, block
    )
    return pos.to(torch.int32), height, prom


def pick_peaks_packed(
    yr: torch.Tensor,  # [P, V] — even logical rows (pair-packed planes)
    yi: torch.Tensor,  # [P, V] — odd logical rows
    scale: torch.Tensor,  # [2P] f32 per logical row (inverse autocorr)
    valid_len: torch.Tensor,  # [2P] int
    distance: int,
    n_peaks: int,
    block: int = 2048,
    plain: bool = False,
):
    """Up to ``n_peaks`` distance-filtered peaks per logical row of the
    pair-packed planes (row 2p = ``yr[p]·scale[2p]``, 2p+1 =
    ``yi[p]·scale[2p+1]``). Tiles are ``min(block, 512)`` columns and V
    must be a multiple of that. ``plain=True`` reduces with the plain
    version on any device (the reference path). Returns (pos int32,
    height, prominence), each [2P, n_peaks]; exhausted slots have height
    −inf."""
    block = min(block, 512)
    if yr.shape[1] % block:
        raise ValueError("crop planes to a block multiple")
    return _pick_peaks_from_source(
        _PackedPairRows(yr, yi, scale, plain), valid_len, distance, n_peaks,
        block,
    )


def pick_peaks_dense(
    x: torch.Tensor,  # [B, V]
    valid_len: torch.Tensor,  # [B] int
    distance: int,
    n_peaks: int,
    block: int = 2048,
    plain: bool = False,
):
    """:func:`pick_peaks_packed` over a materialized [B, V] correlation
    (the JAX package's ``pick_peaks_pallas``): tiles are ``min(block,
    512)`` columns, and V is zero-padded to a multiple of that (callers
    crop to a multiple to avoid the copy). Returns (pos int32, height,
    prominence), each [B, n_peaks]."""
    block = min(block, 512)
    x = x.to(torch.float32)
    if x.shape[1] % block:
        x = torch.nn.functional.pad(x, (0, block - x.shape[1] % block))
    return _pick_peaks_from_source(
        _DenseRows(x.contiguous(), plain), valid_len, distance, n_peaks,
        block,
    )


# ------------------------------------------------ the multi-pass picker
def _masked_rows(x: torch.Tensor, valid_len: torch.Tensor):
    """(x for min [+inf past valid_len], x for max [-inf], colvalid)."""
    cols = torch.arange(x.shape[-1], device=x.device)
    colvalid = cols[None, :] < valid_len[:, None]
    return (
        torch.where(colvalid, x, _POS), torch.where(colvalid, x, _NEG),
        colvalid,
    )


def _local_max_heights(x: torch.Tensor, valid_len: torch.Tensor):
    """Heights at strict local maxima with two neighbours inside the valid
    range, −inf elsewhere."""
    B, V = x.shape
    cols = torch.arange(V, device=x.device)
    interior = (cols[None, :] >= 1) & (cols[None, :] <= valid_len[:, None] - 2)
    edge = torch.zeros((B, 1), dtype=torch.bool, device=x.device)
    up = torch.cat([edge, x[:, 1:] > x[:, :-1]], dim=1)
    down = torch.cat([x[:, :-1] > x[:, 1:], edge], dim=1)
    return torch.where(up & down & interior, x, _NEG)


def _distance_suppress(y: torch.Tensor, distance: int, n_peaks: int):
    """Iterated masked argmax, scipy's greedy-by-height distance filter
    (|Δpos| < distance is suppressed; ties keep the lowest position, an
    all −inf row gives position 0). Overwrites ``y``. Returns ([B, S] pos,
    [B, S] height); exhausted slots have height −inf."""
    B, V = y.shape
    cols = torch.arange(V, device=y.device)
    d = max(int(distance), 1)
    bi = torch.arange(B, device=y.device)
    pos, height = [], []
    for _ in range(n_peaks):
        idx = y.argmax(dim=-1)
        height.append(y[bi, idx])
        pos.append(idx)
        # |col - idx| < d, as two bool compares (no int [B, V] temporary)
        y.masked_fill_((cols[None, :] > (idx - d)[:, None])
                       & (cols[None, :] < (idx + d)[:, None]), _NEG)
    return torch.stack(pos, dim=1), torch.stack(height, dim=1)


def _prominences(x_min, x_max, pos, h, block: int):
    """Prominence of the picks ``pos``/``h`` [B, S] from the masked rows
    ``x_min``/``x_max`` [B, V], through block pyramids of ``block``
    columns."""
    B, V = x_min.shape
    NB = -(-V // block)
    pad = NB * block - V
    if pad:
        x_min = torch.nn.functional.pad(x_min, (0, pad), value=_POS)
        x_max = torch.nn.functional.pad(x_max, (0, pad), value=_NEG)
    x3_min = x_min.reshape(B, NB, block)
    x3_max = x_max.reshape(B, NB, block)
    bi = torch.arange(B, device=x_min.device)[:, None]

    def gather_blocks(pb):
        return x3_min[bi, pb], x3_max[bi, pb]

    return _prominences_from_blocks(
        gather_blocks, x3_min.amin(-1), x3_max.amax(-1), pos, h, block
    )


def pick_peaks_core(x, valid_len, distance: int, n_peaks: int,
                    block: int = 1024):
    """Up to ``n_peaks`` distance-filtered peaks per row of ``x`` [B, V]
    (the JAX package's ``peaks_impl="jnp"``): strict local maxima inside
    ``valid_len`` [B], greedy suppression, prominence from ``block``-column
    pyramids. Returns (pos int32, height, prominence), each [B, n_peaks];
    exhausted slots have height −inf."""
    x = x.to(torch.float32)
    valid_len = valid_len.to(torch.int64)
    x_min, x_max, _ = _masked_rows(x, valid_len)
    pos, height = _distance_suppress(
        _local_max_heights(x_max, valid_len), distance, n_peaks
    )
    prom = _prominences(x_min, x_max, pos, height, block)
    return pos.to(torch.int32), height, prom


pick_peaks_batch = pick_peaks_core  # the JAX package's jitted name


def pick_peaks_dispatch(
    x, valid_len, distance: int, n_peaks: int, block: int, impl: str,
    plain: bool = False,
):
    """Peaks of ``x`` [..., V] with any leading batch shape (flattened
    for the pickers) under ``peaks_impl``: ``"pallas"`` the dense
    single-read picker (``plain`` selects its reduction's plain version),
    ``"jnp"`` the multi-pass picker; the two give identical results."""
    lead = x.shape[:-1]
    x2, v2 = x.reshape(-1, x.shape[-1]), valid_len.reshape(-1)
    if impl == "pallas":
        out = pick_peaks_dense(x2, v2, distance, n_peaks, block, plain)
    elif impl == "jnp":
        out = pick_peaks_core(x2, v2, distance, n_peaks, block)
    else:
        raise ValueError(f"unknown peaks_impl {impl!r}")
    return tuple(o.reshape(*lead, o.shape[-1]) for o in out)


def peaks_crop_width(valid_max: int, block: int, impl: str) -> int:
    """Correlation crop width: for ``"pallas"`` a multiple of the
    reduction's input segment (``min(block, 512)`` × ``GROUP`` columns),
    for ``"jnp"`` the valid range itself."""
    if impl == "pallas":
        unit = min(block, 512) * GROUP
        return -(-valid_max // unit) * unit
    return valid_max


SCIPY_SLOTS = 256  # beyond this many candidate slots, scipy on the host


def find_peaks_slots(V: int, distance: int = 1,
                     n_peaks: int | None = None) -> tuple[int, int] | None:
    """The device picker's (slots, padded width) for :func:`find_peaks_device`
    on a ``V``-long signal: the JAX package's power-of-two bucket of the
    slot count and 4096-multiple of ``V``, which bound its compiled shapes
    (the same buckets keep both packages' picks identical); None past
    ``SCIPY_SLOTS`` slots, where scipy takes the signal on the host."""
    if n_peaks is None:
        # at most ceil(V/distance)+1 peaks can survive the suppression
        n_peaks = min(V // max(int(distance), 1) + 2, max(V // 2, 2))
    if n_peaks > SCIPY_SLOTS:
        return None
    return (1 << max(int(n_peaks) - 1, 1).bit_length(),
            max(-(-V // 4096) * 4096, 4096))


def find_peaks_scipy(x: np.ndarray, distance: int = 1,
                     min_prominence: float = 0.0) -> list[Peak]:
    """:func:`find_peaks_device`'s branch past ``SCIPY_SLOTS`` slots:
    scipy ``find_peaks`` on the host, whose plateau handling differs from
    the device pickers' on exactly tied values."""
    import scipy.signal

    x = np.asarray(x, np.float32)
    logging.getLogger("audio_matcher_torch.peaks").info(
        "find_peaks_device: more than %d candidate slots: using scipy on "
        "the host (plateau ties differ from the device pickers)",
        SCIPY_SLOTS,
    )
    kwargs = {"distance": distance} if distance and distance > 1 else {}
    idx, props = scipy.signal.find_peaks(
        x.astype(np.float64), prominence=(float(min_prominence), None),
        **kwargs,
    )
    return [
        Peak(int(p), float(x[p]), float(pr))
        for p, pr in zip(idx, props["prominences"])
    ]


def pick_padded(x: torch.Tensor, valid_len: torch.Tensor, V_pad: int,
                distance: int, n_peaks: int, block: int = 1024):
    """The device half of :func:`find_peaks_device`: one signal ``x`` [V]
    padded with −inf to ``V_pad`` on its device and picked by
    :func:`pick_peaks_batch` with ``valid_len`` [1] (int64, on the same
    device) → (pos, h, prom), each [1, n_peaks]. Reads nothing from the
    host, so a CUDA graph can capture it."""
    x = torch.nn.functional.pad(x, (0, V_pad - x.shape[-1]), value=_NEG)
    return pick_peaks_batch(x[None], valid_len, int(distance), int(n_peaks),
                            block)


def peaks_from_picks(pos, h, prom, min_prominence: float) -> list[Peak]:
    """One row's picks read back (numpy [n_peaks] each) → the finite ones
    at or above ``min_prominence``, sorted by position."""
    out = [
        Peak(int(p), float(hh), float(pr))
        for p, hh, pr in zip(pos, h, prom)
        if np.isfinite(hh) and pr >= min_prominence
    ]
    out.sort(key=lambda pk: pk.position)
    return out


def find_peaks_device(
    x, distance: int = 1, min_prominence: float = 0.0,
    n_peaks: int | None = None, block: int = 1024, device="cuda",
) -> list[Peak]:
    """Peaks of one signal with scipy ``find_peaks(distance=,
    prominence=)`` semantics, through :func:`pick_peaks_batch` on
    ``device``; more than 256 candidate slots go to scipy on the host,
    whose plateau handling differs on exactly tied values."""
    x = np.asarray(x, np.float32)
    V = x.shape[-1]
    slots = find_peaks_slots(V, distance, n_peaks)
    if slots is None:
        return find_peaks_scipy(x, distance, min_prominence)
    n_peaks, V_pad = slots
    dev = torch.device(device)
    picks = pick_padded(torch.from_numpy(x).to(dev),
                        torch.tensor([V], device=dev), V_pad, distance,
                        n_peaks, block)
    return peaks_from_picks(*(a[0].cpu().numpy() for a in picks),
                            min_prominence)
