"""Single-read peak-candidate reduction (port of ``ops/pallas_kernels.py``).

:func:`local_max_block_reduce_packed` reads the pair-packed correlation
planes once, :func:`local_max_block_reduce` a dense [B, V] correlation,
and both emit, per ``block``-column tile of every (logical) row, the best
strict local maximum (value and global column), the tile minimum and the
tile maximum. Suppression rounds and prominence then work on those small
block arrays (``ops/peaks.py``).

Seam contract (kept from the TPU kernels): columns are grouped in segments
of ``GROUP·block``; the first and last column of each segment are never
candidates here, and ``peaks._merge_seams`` re-checks exactly those. Ties
go to the lowest column (argmax-first); a tile without a candidate reports
−inf at its first column.

The wrappers run the plain versions below for CPU tensors and the CUDA
kernel (``csrc/block_reduce.cu``) for CUDA tensors; they never fall back.
The kernel's geometry is kept here, where the CPU tests reach it: which
warp takes which run of tiles (:func:`reduce_grid`) and which columns of a
tile are valid and may be candidates (:func:`tile_columns`).

:func:`peak_rounds` runs everything the picker does after the reduction
(seam merge, suppression rounds, prominences) in one launch a slab
(``csrc/peak_rounds.cu``); it takes CUDA tensors only, and its plain
version is ``peaks._peak_rounds_plain``; :func:`rounds_layout` is the
layout it launches by the row's tiles, which the kernel's launch also
checks.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .. import _build
from .cuda_fft import on_cuda

GROUP = 128  # tiles per segment
BLOCKS = (128, 256, 512)  # tile widths the CUDA kernel is built for
MAX_V = (1 << 31) - 1  # the kernel's columns and positions are int32
WARPS = 8  # warps of a CUDA block (csrc/block_reduce.cu)
SM_WARPS = 64  # warps an H100 SM holds at once
MAX_RUN = 16  # tiles one warp walks
WAVES = 8  # full waves of warps the runs leave at least
_NEG = float("-inf")
_POS = float("inf")
_ROWS_PER_STEP = 64  # bounds the plain versions' temporaries


def _logical_rows(yr, yi, scale):
    """[P, V] even rows + [P, V] odd rows, scaled → [2P, V]."""
    x = torch.stack([yr, yi], dim=1).reshape(-1, yr.shape[1])
    return x * scale.to(torch.float32)[:, None]


def _reduce_plain(rows: int, V: int, block: int, dev, valid_len, row_block):
    """The reduction over ``rows`` logical rows of V columns;
    ``row_block(r0, r1)`` gives rows [r0, r1) as f32 [r1 - r0, V]."""
    nb = V // block
    seg = GROUP * block
    outs = (
        torch.empty((rows, nb), dtype=torch.float32, device=dev),
        torch.empty((rows, nb), dtype=torch.int32, device=dev),
        torch.empty((rows, nb), dtype=torch.float32, device=dev),
        torch.empty((rows, nb), dtype=torch.float32, device=dev),
    )
    cols = torch.arange(V, device=dev)
    in_seg = cols % seg
    seg_inner = (in_seg != 0) & (in_seg != seg - 1)
    tile_base = torch.arange(nb, device=dev) * block
    valid_len = valid_len.to(torch.int64)
    for r0 in range(0, rows, _ROWS_PER_STEP):
        r1 = min(r0 + _ROWS_PER_STEP, rows)
        x = row_block(r0, r1)
        vl = valid_len[r0:r1, None]
        colvalid = cols[None, :] < vl
        # true neighbours; the column past V reads as the zero pad of the
        # TPU kernel's grid (only reachable when valid_len > V)
        left = torch.nn.functional.pad(x[:, :-1], (1, 0))
        right = torch.nn.functional.pad(x[:, 1:], (0, 1))
        interior = (cols >= 1) & (cols[None, :] <= vl - 2) & seg_inner
        peak = (x > left) & (x > right) & interior & colvalid
        h = torch.where(peak, x, _NEG).reshape(r1 - r0, nb, block)
        outs[0][r0:r1] = h.max(dim=-1).values
        outs[1][r0:r1] = (tile_base + h.argmax(dim=-1)).to(torch.int32)
        outs[2][r0:r1] = (
            torch.where(colvalid, x, _POS).reshape(-1, nb, block).amin(-1)
        )
        outs[3][r0:r1] = (
            torch.where(colvalid, x, _NEG).reshape(-1, nb, block).amax(-1)
        )
    return outs


def local_max_block_reduce_packed_plain(
    yr, yi, scale, valid_len, block: int = 512
):
    """Plain version of :func:`local_max_block_reduce_packed`."""
    P, V = yr.shape

    def rows(r0, r1):  # r0, r1 even: whole planes
        p0, p1 = r0 // 2, r1 // 2
        return _logical_rows(yr[p0:p1], yi[p0:p1], scale[r0:r1])

    return _reduce_plain(2 * P, V, block, yr.device, valid_len, rows)


def local_max_block_reduce_plain(x, valid_len, block: int = 512):
    """Plain version of :func:`local_max_block_reduce`."""
    B, V = x.shape
    return _reduce_plain(
        B, V, block, x.device, valid_len,
        lambda r0, r1: x[r0:r1].to(torch.float32),
    )


def reduce_grid(rows: int, nb: int, sms: int) -> tuple[int, int, int]:
    """The kernel's launch: (run, runs, blocks). Warp w takes run
    ``w % runs`` of row ``w // runs``, tiles [r·run, min(r·run + run, nb)).
    The longest run of at most MAX_RUN tiles (a power of two) that still
    gives WAVES full waves of warps on ``sms`` SMs, else 1: a short last
    wave of long-lived blocks leaves the card part-empty for a block's
    life (``probe_reduce_runs.py``)."""
    run = MAX_RUN
    while run > 1 and rows * -(-nb // run) < WAVES * sms * SM_WARPS:
        run //= 2
    runs = -(-nb // run)
    return run, runs, -(-rows * runs // WARPS)


def warp_tiles(w: int, rows: int, nb: int, run: int, runs: int):
    """(row, first tile, end tile) of warp ``w``, or None past the last
    run: the kernel's assignment."""
    if w >= rows * runs:
        return None
    row, r = divmod(w, runs)
    return row, r * run, min(r * run + run, nb)


def tile_columns(tile: int, block: int, valid_len: int):
    """The kernel's per-tile rule: (valid, candidate) bool [block] of the
    columns of ``tile``. Column j is valid below ``valid_len``, and may be
    a candidate below ``valid_len - 1`` unless it is a segment seam: column
    0 of a tile with tile % GROUP == 0, the last column of a tile with
    tile % GROUP == GROUP - 1."""
    j = torch.arange(block)
    rv = valid_len - tile * block
    valid = j < rv
    cand = j < rv - 1
    if tile % GROUP == 0:
        cand[0] = False
    if tile % GROUP == GROUP - 1:
        cand[-1] = False
    return valid, cand


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_run(dev, rows: int, V: int, block: int) -> int:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return reduce_grid(rows, V // block, _sm_count(index))[0]


def _launchable(planes, block: int) -> None:
    """Refuse what the CUDA reduction cannot read. Rows are not capped: the
    grid is 1-D over warps, and the launch refuses more than 2^31 - 1
    blocks itself."""
    if block not in BLOCKS:
        raise ValueError(f"the CUDA reduction takes block in {BLOCKS}")
    if planes[0].shape[1] > MAX_V:
        raise ValueError(f"at most {MAX_V} columns, got {planes[0].shape[1]}")
    for t in planes:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("rows must be contiguous float32")
        if t.data_ptr() % 16:  # the kernel loads rows as float4
            raise ValueError("rows must start on a 16-byte boundary")


def _block_outputs(rows: int, nb: int, dev):
    bv = torch.empty((rows, nb), dtype=torch.float32, device=dev)
    bp = torch.empty((rows, nb), dtype=torch.int32, device=dev)
    return bv, bp, torch.empty_like(bv), torch.empty_like(bv)


def local_max_block_reduce_packed(yr, yi, scale, valid_len, block: int = 512):
    """One-pass per-tile reduction over pair-packed planes.

    Logical row 2p is ``yr[p]·scale[2p]``, row 2p+1 is ``yi[p]·scale[2p+1]``
    (``scale`` f32 [2P], ``valid_len`` int [2P]). Returns (best_val,
    best_pos, bmin, bmax), each [2P, V // block]; best_pos holds global
    columns (int32).
    """
    P, V = yr.shape
    if yi.shape != yr.shape or V % block:
        raise ValueError(f"planes must be equal [P, V] with V % {block} == 0")
    if scale.shape != (2 * P,) or valid_len.shape != (2 * P,):
        raise ValueError(f"scale and valid_len must be [{2 * P}]")
    if not on_cuda(yr, yi, scale, valid_len):
        return local_max_block_reduce_packed_plain(
            yr, yi, scale, valid_len, block
        )
    _launchable((yr, yi), block)
    scale = scale.to(torch.float32).contiguous()
    valid_len = valid_len.to(torch.int32).contiguous()
    dev = yr.device
    bv, bp, bmin, bmax = _block_outputs(2 * P, V // block, dev)
    with torch.cuda.device(dev):
        rc = _build.load().am_block_reduce_packed(
            yr.data_ptr(), yi.data_ptr(), scale.data_ptr(),
            valid_len.data_ptr(), bv.data_ptr(), bp.data_ptr(),
            bmin.data_ptr(), bmax.data_ptr(), 2 * P, V, block, GROUP,
            _launch_run(dev, 2 * P, V, block),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "am_block_reduce_packed")
    _build.count_launch(local_max_block_reduce_packed)
    return bv, bp, bmin, bmax


local_max_block_reduce_packed.launches = 0


def local_max_block_reduce(x, valid_len, block: int = 512):
    """One-pass per-tile reduction over a dense f32 [B, V] correlation
    (``valid_len`` int [B]); the form of :func:`local_max_block_reduce_packed`
    with no scale and no de-interleave. Returns (best_val, best_pos, bmin,
    bmax), each [B, V // block]."""
    B, V = x.shape
    if V % block:
        raise ValueError(f"rows must be [B, V] with V % {block} == 0")
    if valid_len.shape != (B,):
        raise ValueError(f"valid_len must be [{B}]")
    if not on_cuda(x, valid_len):
        return local_max_block_reduce_plain(x, valid_len, block)
    _launchable((x,), block)
    valid_len = valid_len.to(torch.int32).contiguous()
    dev = x.device
    bv, bp, bmin, bmax = _block_outputs(B, V // block, dev)
    with torch.cuda.device(dev):
        rc = _build.load().am_block_reduce(
            x.data_ptr(), valid_len.data_ptr(), bv.data_ptr(), bp.data_ptr(),
            bmin.data_ptr(), bmax.data_ptr(), B, V, block, GROUP,
            _launch_run(dev, B, V, block),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "am_block_reduce")
    _build.count_launch(local_max_block_reduce)
    return bv, bp, bmin, bmax


local_max_block_reduce.launches = 0

# ------------------------------------------------------------ peak rounds
ROUNDS_SMEM = 200 * 1024  # dynamic shared bytes the shared layout may take
MAX_PEAKS = 4096  # slots a row (the picks' table: 12 bytes a slot)
MAX_DISTANCE = 1 << 62  # the rounds' intervals are int64


def rounds_layout(nb: int, n_peaks: int) -> bool:
    """Whether the rounds over rows of ``nb`` tiles take the shared layout:
    a row's candidates (8 bytes a tile) and the picks' table (12 bytes a
    slot) in shared memory while they fit in ROUNDS_SMEM; else the
    candidates are worked in place in device memory (the L2's)."""
    return 12 * n_peaks + 8 * nb <= ROUNDS_SMEM


def _rounds_refusal(planes, scale, valid_len, reduced, distance: int,
                    n_peaks: int, block: int):
    """Why the rounds kernel cannot take these arguments, or None."""
    bv, bp, bmin, bmax = reduced
    if len(planes) not in (1, 2) or (len(planes) == 2) != (scale is not None):
        return "give (yr, yi) with a scale, or (x,) without"
    rows, nb = bv.shape if bv.dim() == 2 else (0, 0)
    P, V = planes[0].shape
    if any(t.shape != planes[0].shape for t in planes):
        return "yr and yi must have one shape"
    if rows != P * len(planes) or rows < 1:
        return f"candidates must have a row for each of the {P * len(planes)}"
    if nb * block != V:
        return f"candidates must be [{rows}, {V} // {block}]"
    if scale is not None and scale.shape != (rows,):
        return f"scale must be [{rows}]"
    if valid_len.shape != (rows,):
        return f"valid_len must be [{rows}]"
    for t, dtype in zip(reduced, (torch.float32, torch.int32, torch.float32,
                                  torch.float32)):
        if t.shape != (rows, nb) or t.dtype != dtype or not t.is_contiguous():
            return "candidates must be contiguous [rows, nb]: f32, int32, f32, f32"
    if not 1 <= n_peaks <= MAX_PEAKS:
        return f"n_peaks must be 1 to {MAX_PEAKS}, got {n_peaks}"
    if distance > MAX_DISTANCE:
        return f"distance must be at most {MAX_DISTANCE}"
    return None


def peak_rounds(planes, scale, valid_len, reduced, distance: int,
                n_peaks: int, block: int = 512):
    """The picker's rounds over a slab's reduced rows, one launch: the seam
    merge, ``n_peaks`` suppression rounds at min distance ``distance``
    with the rescan of each pick's edge tiles, and every slot's prominence.

    ``planes`` is (yr, yi) [P, V] with ``scale`` f32 [2P] (logical row 2p
    = yr[p]·scale[2p], 2p+1 = yi[p]·scale[2p+1]) or (x,) [B, V] with
    ``scale`` None; ``reduced`` the reduction's (best_val, best_pos, bmin,
    bmax) over ``block``-column tiles, each [rows, V // block], of which
    the first two are overwritten. Returns (pos int32, height, prominence),
    each [rows, n_peaks], bit for bit ``peaks._peak_rounds_plain``'s.
    Refuses what the kernel cannot take, CPU tensors among it."""
    d = max(int(distance), 1)
    why = _rounds_refusal(planes, scale, valid_len, reduced, d, n_peaks,
                          block)
    if why is not None:
        raise ValueError(why)
    _launchable(planes, block)
    tensors = (*planes, valid_len, *reduced) + (() if scale is None
                                                 else (scale,))
    if not on_cuda(*tensors):
        raise ValueError("the rounds kernel takes CUDA tensors; the plain "
                         "rounds are ops/peaks.py's")
    packed = scale is not None
    bv, bp, bmin, bmax = reduced
    rows, nb = bv.shape
    V = planes[0].shape[1]
    dev = bv.device
    valid_len = valid_len.to(torch.int32).contiguous()
    scale = scale.to(torch.float32).contiguous() if packed else None
    shared = rounds_layout(nb, n_peaks)
    pos = torch.empty((rows, n_peaks), dtype=torch.int32, device=dev)
    height = torch.empty((rows, n_peaks), dtype=torch.float32, device=dev)
    prom = torch.empty_like(height)
    yr, yi = planes if packed else (planes[0], planes[0])
    with torch.cuda.device(dev):
        rc = _build.load().am_peak_rounds(
            yr.data_ptr(), yi.data_ptr(),
            scale.data_ptr() if packed else None, valid_len.data_ptr(),
            bv.data_ptr(), bp.data_ptr(), bmin.data_ptr(), bmax.data_ptr(),
            pos.data_ptr(), height.data_ptr(), prom.data_ptr(), rows, V,
            block, GROUP, d, n_peaks, int(packed), int(shared),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "am_peak_rounds")
    _build.count_launch(peak_rounds)
    return pos, height, prom


peak_rounds.launches = 0

KERNELS = (local_max_block_reduce_packed, local_max_block_reduce,
           peak_rounds)
