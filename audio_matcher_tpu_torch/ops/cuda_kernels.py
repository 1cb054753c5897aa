"""Single-read peak-candidate reduction (port of ``ops/pallas_kernels.py``).

:func:`local_max_block_reduce_packed` reads the pair-packed correlation
planes once and emits, per ``block``-column tile of every logical row, the
best strict local maximum (value and global column), the tile minimum and
the tile maximum. Suppression rounds and prominence then work on those
small block arrays (``ops/peaks.py``).

Seam contract (kept from the TPU kernel): columns are grouped in segments
of ``GROUP·block``; the first and last column of each segment are never
candidates here, and ``peaks._merge_seams`` re-checks exactly those. Ties
go to the lowest column (argmax-first); a tile without a candidate reports
−inf at its first column.

The wrapper runs the plain version below for CPU tensors and the CUDA
kernel (``csrc/block_reduce.cu``) for CUDA tensors; it never falls back.
"""

from __future__ import annotations

import torch

from .. import _build
from .cuda_fft import on_cuda

GROUP = 128  # tiles per segment
BLOCKS = (128, 256, 512)  # tile widths the CUDA kernel is built for
_NEG = float("-inf")
_POS = float("inf")


def _logical_rows(yr, yi, scale):
    """[P, V] even rows + [P, V] odd rows, scaled → [2P, V]."""
    x = torch.stack([yr, yi], dim=1).reshape(-1, yr.shape[1])
    return x * scale.to(torch.float32)[:, None]


_PLANES_PER_STEP = 32  # bounds the plain version's temporaries


def local_max_block_reduce_packed_plain(
    yr, yi, scale, valid_len, block: int = 512
):
    """Plain version of :func:`local_max_block_reduce_packed`, a few
    planes at a time."""
    P, V = yr.shape
    nb = V // block
    seg = GROUP * block
    dev = yr.device
    outs = (
        torch.empty((2 * P, nb), dtype=torch.float32, device=dev),
        torch.empty((2 * P, nb), dtype=torch.int32, device=dev),
        torch.empty((2 * P, nb), dtype=torch.float32, device=dev),
        torch.empty((2 * P, nb), dtype=torch.float32, device=dev),
    )
    cols = torch.arange(V, device=dev)
    in_seg = cols % seg
    seg_inner = (in_seg != 0) & (in_seg != seg - 1)
    tile_base = torch.arange(nb, device=dev) * block
    valid_len = valid_len.to(torch.int64)
    for p0 in range(0, P, _PLANES_PER_STEP):
        sl = slice(p0, p0 + _PLANES_PER_STEP)
        x = _logical_rows(yr[sl], yi[sl], scale[2 * p0 : 2 * sl.stop])
        vl = valid_len[2 * p0 : 2 * sl.stop, None]
        colvalid = cols[None, :] < vl
        # true neighbours; the column past V reads as the zero pad of the
        # TPU kernel's grid (only reachable when valid_len > V)
        left = torch.nn.functional.pad(x[:, :-1], (1, 0))
        right = torch.nn.functional.pad(x[:, 1:], (0, 1))
        interior = (cols >= 1) & (cols[None, :] <= vl - 2) & seg_inner
        peak = (x > left) & (x > right) & interior & colvalid
        h = torch.where(peak, x, _NEG).reshape(x.shape[0], nb, block)
        rows = slice(2 * p0, 2 * p0 + x.shape[0])
        outs[0][rows] = h.max(dim=-1).values
        outs[1][rows] = (tile_base + h.argmax(dim=-1)).to(torch.int32)
        outs[2][rows] = (
            torch.where(colvalid, x, _POS).reshape(-1, nb, block).amin(-1)
        )
        outs[3][rows] = (
            torch.where(colvalid, x, _NEG).reshape(-1, nb, block).amax(-1)
        )
    return outs


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
    if block not in BLOCKS:
        raise ValueError(f"the CUDA reduction takes block in {BLOCKS}")
    if 2 * P > 65535:
        raise ValueError(f"at most 65535 logical rows per launch, got {2 * P}")
    for t in (yr, yi):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("planes must be contiguous float32")
        if t.data_ptr() % 16:  # the kernel loads rows as float4
            raise ValueError("planes must start on a 16-byte boundary")
    scale = scale.to(torch.float32).contiguous()
    valid_len = valid_len.to(torch.int32).contiguous()
    nb = V // block
    dev = yr.device
    bv = torch.empty((2 * P, nb), dtype=torch.float32, device=dev)
    bp = torch.empty((2 * P, nb), dtype=torch.int32, device=dev)
    bmin = torch.empty_like(bv)
    bmax = torch.empty_like(bv)
    with torch.cuda.device(dev):
        rc = _build.load().am_block_reduce_packed(
            yr.data_ptr(), yi.data_ptr(), scale.data_ptr(),
            valid_len.data_ptr(), bv.data_ptr(), bp.data_ptr(),
            bmin.data_ptr(), bmax.data_ptr(), 2 * P, V, block, GROUP,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "am_block_reduce_packed")
    local_max_block_reduce_packed.launches += 1
    return bv, bp, bmin, bmax


local_max_block_reduce_packed.launches = 0

KERNELS = (local_max_block_reduce_packed,)
