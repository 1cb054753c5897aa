"""Launch plan of the CUDA FFT passes (``csrc/fft_passes.cuh``,
``csrc/fft_major.cu``, ``csrc/fft_minor.cu``).

A pass transforms lines of L = 2^b points (a contiguous row in the minor
pass, a strided column in the major pass) with the radix-2 DIF butterflies
and twiddles of the plain algorithm, grouped: each thread holds
``PTS`` = 16 points of a line in registers, the points whose indices vary
over one 4-bit window [w, w + 4) of the index, and runs the 3 or 4
consecutive stages whose bits lie in that window without touching shared
memory. Shared memory carries only the exchanges between groups: two for
L = 2048 (groups of 4 + 4 + 3 stages) instead of eleven round trips.

This module is the host side of that design, kept apart from the
wrappers so the CPU tests reach it: the stage groups of each L (the
grouping the kernels' compile-time ``Plan`` makes); the strip width and
thread count of the major pass; the shared-memory bytes of each pass; the
shared-memory address of a point in each pass's exchange tile (the same
functions as the kernels' ``MinorTile`` and ``MajorTile``), with which a
test counts bank conflicts; the wire passes' copy of a strip's rows into
shared memory (``wire_copy``, ``wire_layout``), their output's staging
for the TMA stores (``stage_word``, ``wire_box``) and the strips each
persistent block walks (``block_strips``); and the plain per-stage
twiddle table.
"""

from __future__ import annotations

import math

import torch

PTS = 16  # points a thread holds
LOG2_PTS = 4
MIN_LOG2, MAX_LOG2 = 7, 12  # factors 128 .. 4096
MINOR_THREADS = 256
MAJOR_TILE_LOG2 = 14  # points of a major-pass strip: C·A = 2^14 ...
MAJOR_MIN_LOG2C = 2  # ... and at least 4 columns (16 bytes of a row)
MAX_SMEM = 232448  # bytes a Hopper block may use (227 KB)
BANKS = 32
LUT_COPIES = 16  # copies of the wire passes' mu-law table


def stage_groups(log2L: int) -> list[tuple[int, int, int]]:
    """The forward pass's stage groups, top bits first, as
    (w, qlo, k): the thread's window of index bits [w, w + 4) and the
    group's stages on bits w + qlo .. w + qlo + k - 1 (k = 3 or 4). The
    inverse runs the same groups in reverse order. The windows of the
    first and last group are [b - 4, b) and [0, 4)."""
    if not MIN_LOG2 <= log2L <= MAX_LOG2:
        raise ValueError(f"no stage groups for L = 2^{log2L}")
    ng = -(-log2L // LOG2_PTS)
    fours = log2L - 3 * ng
    sizes = [4] * fours + [3] * (ng - fours)
    out, hi = [], log2L
    for k in sizes:
        lo = hi - k
        if k == LOG2_PTS:
            w = lo
        else:  # one more bit rides along: the next one up, or down at the top
            w = lo if lo + k < log2L else lo - 1
        out.append((w, lo - w, k))
        hi = lo
    return out


def position(u: int, r: int, w: int) -> int:
    """Index in its line of register ``r`` of thread ``u`` when the
    thread holds window [w, w + 4): r fills the window, u the other
    bits in order."""
    low = u & ((1 << w) - 1)
    return low | (u >> w) << (w + LOG2_PTS) | r << w


def major_strip_log2(log2A: int) -> int:
    """log2 of the major pass's strip width C: 2^14 points per block (at
    most 1024 threads, 16 points each), at most 32 columns (128 bytes of a
    row per plane): C = 32 up to A = 512, 16 at 1024, 8 at 2048, 4 at
    4096, where 8 columns would need 278 KB of tile."""
    return max(MAJOR_MIN_LOG2C, min(5, MAJOR_TILE_LOG2 - log2A))


def major_threads(log2A: int) -> int:
    return 1 << (major_strip_log2(log2A) + log2A - LOG2_PTS)


def major_smem_bytes(log2A: int, planes: bool = False, elem_size: int = 4,
                     pair: bool = True) -> int:
    """The f32 planes' passes (``planes``): three planes of the
    [A + A/16, C] exchange tile (the next strip's two, copied in while the
    block works, and one to exchange through), 17 cross twiddles (float2)
    per column and one float2 a thread. The wire passes: ``wire_layout``'s
    bytes for wire elements of ``elem_size`` bytes (the default, f32 pairs,
    is the largest)."""
    if not planes:
        return wire_layout(log2A, elem_size, pair)["smem"]
    A = 1 << log2A
    C = 1 << major_strip_log2(log2A)
    tile = (A + A // 16) * C
    return 4 * (3 * tile + 2 * major_threads(log2A) + 34 * C)


def wire_stride(elem_size: int, log2C: int) -> int:
    """Bytes of shared memory a row piece of a strip takes in the wire
    passes: f32 pieces exactly; u8 and int16 pieces up to 4 bytes more (the
    lead of a 4-byte word copy), rounded up to their widest copy (16 bytes,
    or the piece where it is shorter)."""
    piece = elem_size << log2C
    if elem_size == 4:
        return piece
    wide = min(16, piece)
    return -(-(piece + 4) // wide) * wide


def wire_copy(elem_size: int, log2C: int, start: int) -> tuple[int, int, int]:
    """How the wire passes copy one row piece of a strip (C elements of
    ``elem_size`` bytes from byte address ``start``) into shared memory, as
    (grain, lead, chunks): ``chunks`` cp.async copies of ``grain`` bytes
    from ``start - lead``. f32 rows are copied exactly in the largest of
    16, 8 or 4 bytes that divides the start. u8 and int16 rows likewise in
    16 or 8 bytes where the start and the piece allow it (one copy a row at
    config #3's 8-byte pieces); else in the 4-byte words that their bytes
    touch, from the word that holds the first byte (``lead`` = start mod
    4)."""
    piece = elem_size << log2C
    if elem_size == 4:
        g = 16 if start % 16 == 0 else 8 if start % 8 == 0 else 4
        return g, 0, piece // g
    for g in (16, 8):
        if g <= piece and start % g == 0:
            return g, 0, piece // g
    lead = start % 4
    return 4, lead, -(-(lead + piece) // 4)


def wire_layout(log2A: int, elem_size: int, pair: bool) -> dict[str, int]:
    """The wire passes' shared memory (``WireLayout`` in fft_major.cu), in
    bytes: the exchange tile, one plane; ``tma``: a dense [A, C] plane
    beside it that stages the real output plane for the TMA stores, where a
    strip's output row piece is shorter than a 32-byte sector (A = 4096)
    and it fits; the strip's wire rows (``stride`` bytes each, A rows a
    plane, one plane or two for ``pair``); for mu-law the 256 decoded codes
    LUT_COPIES times; the cross twiddles and a float2 a thread."""
    A = 1 << log2A
    log2C = major_strip_log2(log2A)
    tile = 4 * (A + A // 16 << log2C)
    stride = wire_stride(elem_size, log2C)
    raw = (2 if pair else 1) * A * stride
    lut = 4 * 256 * LUT_COPIES if elem_size == 1 else 0
    rest = raw + lut + 8 * (PTS + 1 << log2C) + 8 * major_threads(log2A)
    tma = 4 << log2C < 32 and tile + 4 * (A << log2C) + rest <= MAX_SMEM
    stage = 4 * (A << log2C) if tma else 0
    return {"tile": tile, "stage": stage, "piece": elem_size << log2C,
            "stride": stride, "raw": raw, "tma": int(tma),
            "smem": tile + stage + rest}


def wire_box(log2A: int) -> int:
    """Rows of a TMA store's box: a strip's C columns by this many rows
    (at most 256, the TMA's limit), A / box boxes a plane of a strip."""
    return min(1 << log2A, 256)


def stage_word(log2A: int, tid: int, r: int) -> int:
    """The word of the [A, C] staging arrays (the real plane's beside the
    exchange tile, the imaginary plane's in it) that thread ``tid`` writes
    at step ``r`` of the wire passes' TMA output: row (u << 4 | r) ^ k,
    column col,
    with k = u mod 32/C, so that the rows of a warp's writes differ modulo
    32/C (``stage_and_store``)."""
    log2C = major_strip_log2(log2A)
    col, u = tid & ((1 << log2C) - 1), tid >> log2C
    k = u & ((32 >> log2C) - 1)
    return ((u << LOG2_PTS | r) ^ k) << log2C | col


def block_strips(P: int, log2A: int, log2M: int, blocks: int) -> list[range]:
    """The strips each block of a major pass walks: block b takes strips
    b, b + blocks, ... of the P·M/C, where strip s is columns
    (s mod M/C)·C of plane s // (M/C)."""
    strips = P << (log2M - major_strip_log2(log2A))
    return [range(b, strips, blocks) for b in range(min(blocks, strips))]


def minor_smem_bytes(product: bool = False) -> int:
    """Two f32 planes of MINOR_THREADS·PTS points, whatever M; the product
    mode keeps its window rows in as much again."""
    return (4 if product else 2) * 4 * MINOR_THREADS * PTS


def minor_address(line: int, i: int, log2M: int) -> int:
    """Word of point i of block line ``line`` in a plane of the minor
    exchange tile: index g = line·M + i with bits 5-8 of g XORed into its
    low five bits (as ``MinorTile::at``), which keeps every exchange of
    every M free of bank conflicts."""
    g = (line << log2M) + i
    return g ^ ((g >> 5 & 1) | (g >> 6 & 1) << 1 | (g >> 7 & 1) << 3
                | (g >> 8 & 1) * 20)


def major_address(col: int, i: int, log2C: int) -> int:
    """Word of point i of strip column ``col`` in a plane of the major
    exchange tile: rows of C words, one padding row per 16 (as
    ``MajorTile::at``)."""
    return (i + (i >> 4) << log2C) + col


def exchange_conflicts(log2L: int, major: bool) -> int:
    """The most words one bank serves in a single warp access of any
    exchange of the pass (1: conflict-free), for 4-byte accesses of one
    plane by each register of each warp of a block."""
    T = 1 << (log2L - LOG2_PTS)
    log2C = major_strip_log2(log2L) if major else 0
    threads = major_threads(log2L) if major else MINOR_THREADS
    worst = 1
    for w, _, _ in stage_groups(log2L):
        for warp in range(0, threads, 32):
            for r in range(PTS):
                banks: dict[int, set[int]] = {}
                for tid in range(warp, warp + 32):
                    if major:
                        col, u = tid & ((1 << log2C) - 1), tid >> log2C
                        a = major_address(col, position(u, r, w), log2C)
                    else:
                        line, u = tid // T, tid % T
                        a = minor_address(line, position(u, r, w), log2L)
                    banks.setdefault(a % BANKS, set()).add(a)
                worst = max(worst, max(len(s) for s in banks.values()))
    return worst


def twiddle_table_plain(L: int, device=None) -> torch.Tensor:
    """The per-stage twiddle table as [L, 2] f32 (re, im): entry m + j is
    W_{2m}^j = exp(-πi·j/m) for m = 2^p < L and j < m (entry 0 is 1).
    Computed in float64 and rounded once, the value the kernel's
    ``sincospif`` of the exact argument -j/m gives within an ulp."""
    k = torch.arange(L, dtype=torch.int64)
    p = torch.tensor([max(int(x).bit_length() - 1, 0) for x in k])
    j = k - (1 << p)
    j[0] = 0
    ang = -math.pi * j.to(torch.float64) / (1 << p).to(torch.float64)
    tw = torch.stack([torch.cos(ang), torch.sin(ang)], dim=1)
    return tw.to(torch.float32).to(device)
