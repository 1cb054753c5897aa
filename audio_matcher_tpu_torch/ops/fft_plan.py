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
grouping the kernels' compile-time ``Plan`` makes); the strip width,
cluster size and thread count of the major pass, and at A ≥ 8192 every
index map of its cluster passes (``cluster_*``); the shared-memory bytes
of each pass; the
shared-memory address of a point in each pass's exchange tile (the same
functions as the kernels' ``MinorTile`` and ``MajorTile``), with which a
test counts bank conflicts; the wire passes' copy of a strip's rows into
shared memory (``wire_copy``, ``wire_layout``), their output's staging
for the TMA stores (``stage_word``, ``wire_box``) and the strips each
persistent block walks (``block_strips``); and the plain per-stage
twiddle table; and the cross twiddle's split exponent above n = 2^24
(``cross_root_plain``).

Factors run from 2^7 to 2^14 (fft_len up to 2^28). Up to 4096 a minor
block is MINOR_THREADS threads holding 4096/M rows, and a major strip is
C = 4 to 32 columns, one block's. At 8192 and 16384 a row of the forward
and inverse minor modes is shared by a cluster of M/4096 such blocks
(``fft_minor.cu``'s rows on clusters, ``minor_cluster_*``: the top stage
group across the cluster, the others on a block's 4096 points), the
product mode's block is one row of M/16 threads, and a major strip of C
= 8 columns is shared by a cluster of K = A/2048 blocks
(``fft_major.cu``'s passes on clusters): block b transforms rows b + K·a1
over a1 as a block of A = 2048 does, and one exchange through the
cluster runs the K-point stage.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PTS = 16  # points a thread holds
LOG2_PTS = 4
MIN_LOG2, MAX_LOG2 = 7, 14  # factors 128 .. 16384
MINOR_THREADS = 256
MAJOR_TILE_LOG2 = 14  # points of a major-pass strip: C·A = 2^14 ...
MAJOR_MIN_LOG2C = 2  # ... and at least 4 columns (16 bytes of a row) ...
WIDE_LOG2 = 12  # ... up to A = 4096; wider factors run on clusters:
CLUSTER_BLOCK_LOG2 = 11  # a block's rows of a cluster's strip (2048) ...
CLUSTER_LOG2C = 3  # ... of 8 columns, whole 32-byte sectors of a row
CLUSTER_INNER = 128 + 16  # inner twiddles (float2) a cluster block keeps
EXACT_LOG2N = 24  # f32 holds every integer exponent k < n up to here
PADDED_MINOR_LOG2 = 13  # product tiles above this are padded, not swizzled
MINOR_ROW_LOG2 = 12  # points of a row a minor block holds; wider rows of
# the forward and inverse modes run on clusters of M / 4096 blocks ...
MINOR_CLUSTER_BLOCKS = 4  # ... 4 of them an SM (64 registers a thread)
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


def major_cluster_log2(log2A: int) -> int:
    """log2 of the blocks that share a major strip: 1 up to A = 4096; A /
    2048 (4, 8) at 8192 and 16384, a cluster."""
    return log2A - CLUSTER_BLOCK_LOG2 if log2A > WIDE_LOG2 else 0


def major_block_log2(log2A: int) -> int:
    """log2 of the rows of a strip one block transforms: A, or 2048 on a
    cluster."""
    return log2A - major_cluster_log2(log2A)


def major_strip_log2(log2A: int) -> int:
    """log2 of the major pass's strip width C: 2^14 points per block (at
    most 1024 threads, 16 points each), at most 32 columns (128 bytes of a
    row per plane): C = 32 up to A = 512, 16 at 1024, 8 at 2048, 4 at
    4096, where 8 columns would need 278 KB of tile; 8 at 8192 and 16384,
    a cluster's, whose blocks hold 2048 rows each (2^14 points)."""
    if log2A > WIDE_LOG2:
        return CLUSTER_LOG2C
    return max(MAJOR_MIN_LOG2C, min(5, MAJOR_TILE_LOG2 - log2A))


def major_threads(log2A: int) -> int:
    return 1 << (major_strip_log2(log2A) + major_block_log2(log2A)
                 - LOG2_PTS)


def major_strips(P: int, log2A: int, log2M: int) -> int:
    """The strips of a major pass over P planes, P·M/C: each one block's,
    or at A ≥ 8192 one cluster's; the kernels count them in an int."""
    return P << (log2M - major_strip_log2(log2A))


def major_smem_bytes(log2A: int, planes: bool = False, elem_size: int = 4,
                     pair: bool = True) -> int:
    """The f32 planes' passes (``planes``): three planes of the
    [B + B/16, C] exchange tile of the block's B rows (the next strip's
    two, copied in while the block works, and one to exchange through),
    17 cross twiddles (float2) per column, one float2 a thread and, on a
    cluster, the inner twiddles. The wire passes: ``wire_layout``'s bytes
    for wire elements of ``elem_size`` bytes (the default, f32 pairs, is
    the largest)."""
    if not planes:
        return wire_layout(log2A, elem_size, pair)["smem"]
    B = 1 << major_block_log2(log2A)
    C = 1 << major_strip_log2(log2A)
    tile = (B + B // 16) * C
    inner = 8 * CLUSTER_INNER if major_cluster_log2(log2A) else 0
    return 4 * (3 * tile + 2 * major_threads(log2A) + 34 * C) + inner


def wire_stride(elem_size: int, log2C: int) -> int:
    """Bytes of shared memory a row piece of a strip takes in the wire
    passes: f32 pieces exactly; u8 and int16 pieces up to 4 bytes more (the
    lead of a 4-byte word copy), rounded up to their widest copy (16 bytes,
    or the piece where it is shorter); pieces under 4 bytes (strips of 1
    or 2 columns, which no pass takes since the cluster passes) the 4-byte
    words that the piece and its largest lead (4 - elem_size bytes)
    touch."""
    piece = elem_size << log2C
    if elem_size == 4:
        return piece
    if piece < 4:
        return -(-(piece + 4 - elem_size) // 4) * 4
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
        g = min(g, piece)
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
    strip's output row piece is half a 32-byte sector (A = 4096: a TMA box
    row is a multiple of 16 bytes) and it fits; the strip's wire rows
    (``stride`` bytes each, A rows a plane, one plane or two for ``pair``);
    for mu-law the 256 decoded codes LUT_COPIES times; the cross twiddles
    and a float2 a thread. On a cluster (A ≥ 8192) the layout of the
    block's 2048 rows, and the inner twiddles."""
    A = 1 << major_block_log2(log2A)
    log2C = major_strip_log2(log2A)
    tile = 4 * (A + A // 16 << log2C)
    stride = wire_stride(elem_size, log2C)
    raw = (2 if pair else 1) * A * stride
    lut = 4 * 256 * LUT_COPIES if elem_size == 1 else 0
    rest = raw + lut + 8 * (PTS + 1 << log2C) + 8 * major_threads(log2A)
    if major_cluster_log2(log2A):
        rest += 8 * CLUSTER_INNER
    tma = 4 << log2C == 16 and tile + 4 * (A << log2C) + rest <= MAX_SMEM
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
    """The strips each walker of a major pass walks (``blocks`` of them:
    blocks, or at A ≥ 8192 clusters, whose blocks all walk their
    cluster's): walker b takes strips b, b + blocks, ... of the P·M/C,
    where strip s is columns (s mod M/C)·C of plane s // (M/C)."""
    strips = major_strips(P, log2A, log2M)
    return [range(b, strips, blocks) for b in range(min(blocks, strips))]


# ------------------------------------------ the cluster passes' index maps
# A = K·2048 (K = 4, 8); block b of a strip's cluster, thread tid = (col,
# u) = (tid mod 8, tid // 8), u < 128, register r < 16. R = 2048 / K
# positions of a block's 2048-point transform go to each block. Each map
# takes numpy arrays (or ints) and is the kernel's formula.
def cluster_forward_row(log2A: int, b, a1):
    """The plane row of row a1 of block b's forward transform: b + K·a1
    (``fetch_cluster_strip``, ``fetch_cluster_wire_plane``)."""
    return b + (np.asarray(a1) << major_cluster_log2(log2A))


def cluster_inverse_raw_slot(log2A: int, rho):
    """The row slot of physical row 2048·b + rho in the inverse's copy of
    the strip: rho ^ ((rho >> log2K) & 3), unpadded (rows of 8 words)."""
    rho = np.asarray(rho)
    return rho ^ ((rho >> major_cluster_log2(log2A)) & 3)


def cluster_push_forward(log2A: int, b, u, r):
    """Where the forward sends position (u << 4) | r of block b's
    transform: (destination block, slot of its exchange tile)."""
    lk = major_cluster_log2(log2A)
    low = 7 - lk
    u, r = np.asarray(u), np.asarray(r)
    slot = (b << (CLUSTER_BLOCK_LOG2 - lk)) + ((u & ((1 << low) - 1)) << 4) + r
    return u >> low, slot


def cluster_pull_forward(log2A: int, v, r):
    """The slot thread v of a block takes into register r = j·K + b of the
    K-point stage: b·R + 128·j + v (``pull_forward``)."""
    lk = major_cluster_log2(log2A)
    r = np.asarray(r)
    return ((r & ((1 << lk) - 1)) << (CLUSTER_BLOCK_LOG2 - lk)) + (
        (r >> lk) << 7) + v


def cluster_push_inverse(log2A: int, b, v, r):
    """Where the inverse sends register r = j·K + b2 of thread v of block
    b (residue b2 of position r1 = b·R + v + 128·j): (block b2, slot r1)."""
    lk = major_cluster_log2(log2A)
    r = np.asarray(r)
    return r & ((1 << lk) - 1), (b << (CLUSTER_BLOCK_LOG2 - lk)) + v + (
        (r >> lk) << 7)


def cluster_stage_row(log2A: int, b, v, r):
    """The physical row of register r = j·K + r2 of thread v of block b in
    the K-point stage: K·(b·R + v + 128·j) + r2, the forward's stores and
    the inverse's loads; brev_A of it is brev_2048(b·R + v) (the thread's
    cross base) + ``cluster_cross_exponent(r)``."""
    lk = major_cluster_log2(log2A)
    r = np.asarray(r)
    r1 = (b << (CLUSTER_BLOCK_LOG2 - lk)) + v + ((r >> lk) << 7)
    return (r1 << lk) + (r & ((1 << lk) - 1))


def cluster_cross_exponent(log2A: int, r):
    """E(r) = brev_2048(128·j) + 2048·brev_K(r2) of register r = j·K + r2
    (``cluster_cross_exponent``): the cross twiddle table's exponent."""
    lk = major_cluster_log2(log2A)
    r = np.asarray(r)
    return brev(r >> lk << 7, CLUSTER_BLOCK_LOG2) + (
        brev(r & ((1 << lk) - 1), lk) << CLUSTER_BLOCK_LOG2)


def cluster_inverse_row(log2A: int, b, u, r):
    """The natural row the inverse writes from register r of thread u of
    block b: b + K·(u + 128·r) (written where it is below a_crop)."""
    return b + ((np.asarray(u) + (np.asarray(r) << 7))
                << major_cluster_log2(log2A))


def brev(x, bits: int):
    """Bit reversal of x over ``bits`` bits (numpy arrays or ints)."""
    x = np.asarray(x, np.int64)
    out = np.zeros_like(x)
    for i in range(bits):
        out |= ((x >> i) & 1) << (bits - 1 - i)
    return out


def minor_cluster_log2(log2M: int, product: bool = False) -> int:
    """log2 of the blocks that share a row of the minor pass: 0 up to M =
    4096 and in the product mode; M / 4096 (2, 4) for the forward and
    inverse modes at 8192 and 16384, a cluster (``MinorCluster``)."""
    return 0 if product else max(0, log2M - MINOR_ROW_LOG2)


def minor_threads(log2M: int, product: bool = False) -> int:
    """Threads of a minor block: MINOR_THREADS (4096/M rows) up to M =
    4096, and each of a cluster's blocks (4096 points of a row) above; the
    product mode's one row of M/16 threads above."""
    if product:
        return max(MINOR_THREADS, 1 << (log2M - LOG2_PTS))
    return MINOR_THREADS


def minor_tile_words(log2M: int, product: bool = False) -> int:
    """Words of a plane of the minor exchange tile: minor_threads·PTS,
    and a padding word each 16 in the product mode at M = 16384
    (``minor_address``)."""
    points = minor_threads(log2M, product) * PTS
    if product and log2M > PADDED_MINOR_LOG2:
        return points + points // 16
    return points


def minor_smem_bytes(log2M: int, product: bool = False) -> int:
    """The exchange tiles, two f32 planes of ``minor_tile_words``; the
    product mode keeps its window rows in two planes of
    minor_threads·PTS more up to M = 8192 (at 16384 the rows and two
    tiles would pass MAX_SMEM: it reads them again for each query pair)."""
    keep = product and log2M <= PADDED_MINOR_LOG2
    rows = 2 * minor_threads(log2M, product) * PTS if keep else 0
    return 4 * (2 * minor_tile_words(log2M, product) + rows)


def minor_address(line: int, i: int, log2M: int,
                  product: bool = False) -> int:
    """Word of point i of block line ``line`` in a plane of the minor
    exchange tile: index g = line·M + i with bits 5-8 of g XORed into its
    low five bits (as ``MinorTile::at``), which keeps every exchange of
    every M up to 8192 free of bank conflicts. On a cluster (M ≥ 8192,
    forward and inverse) i is the point's index among its block's 4096
    (line 0). In the product mode at M = 16384 (one line of 1024 threads
    with 64 registers each) the padded line of ``major_address`` at one
    column, whose steps are immediates."""
    if product and log2M > PADDED_MINOR_LOG2:
        return major_address(0, i, 0)
    g = (line << min(log2M, MINOR_ROW_LOG2)) + i
    return g ^ ((g >> 5 & 1) | (g >> 6 & 1) << 1 | (g >> 7 & 1) << 3
                | (g >> 8 & 1) * 20)


# ------------------------------- the minor pass's rows on clusters
# M = K·4096 (K = 2, 4), forward and inverse: block b of a row's cluster,
# thread t < 256, register r < 16. The top stage group (window [W0, W0 +
# 4), W0 = log2 M - 4) runs on thread U = 256·b + t of the cluster; every
# other group on block b's points 4096·b .. 4096·b + 4095 as at M = 4096.
# The exchange between the two layouts goes through each block's tile
# unswizzled (word = slot). Each map takes numpy arrays (or ints) and is
# the kernel's formula.
def _minor_windows(log2M: int) -> tuple[int, int]:
    """(W0, W1): the windows of the top group and of the next one."""
    groups = stage_groups(log2M)
    return groups[0][0], groups[1][0]


def minor_cluster_top(log2M: int, b, t, r):
    """The index in its row of register r of thread t of block b in the
    top group: U + 2^W0·r, U = 256·b + t (the forward's loads, the
    inverse's stores)."""
    w0, _ = _minor_windows(log2M)
    return (np.asarray(b) << 8 | np.asarray(t)) + (np.asarray(r) << w0)


def minor_cluster_point(log2M: int, b, t, r):
    """The index in its row of register r of thread t of block b at the
    next group's window W1: 4096·b + position(t, r, W1) (the forward's
    takes, the inverse's sends)."""
    _, w1 = _minor_windows(log2M)
    return (np.asarray(b) << MINOR_ROW_LOG2) + position(
        np.asarray(t), np.asarray(r), w1)


def minor_cluster_send_forward(log2M: int, b, t, r):
    """Where the forward sends register r of thread t of block b after the
    top group, as (block, word): point g = U + 2^W0·r goes to block r >>
    (4 - log2 K), word U + 2^W0·(r mod 2^(4 - log2 K)): g >> 12, g mod
    4096 (``send_forward``)."""
    w0, _ = _minor_windows(log2M)
    low = LOG2_PTS - minor_cluster_log2(log2M)
    r = np.asarray(r)
    u = np.asarray(b) << 8 | np.asarray(t)
    return r >> low, u + ((r & ((1 << low) - 1)) << w0)


def minor_cluster_inverse_slot(log2M: int, g):
    """The word of the tile of block (g >> 8) mod K where point g arrives
    for the inverse's top group: thread g mod 256, register g >> W0,
    (g mod 256) + 256·(g >> W0) (``inverse_slot``)."""
    w0, _ = _minor_windows(log2M)
    g = np.asarray(g)
    return (g & 255) | (g >> w0) << 8


def minor_cluster_send_inverse(log2M: int, b, t, r):
    """Where the inverse sends register r of thread t of block b after the
    next group, as (block, word), the way ``send_inverse`` forms them: the
    block from the register alone, ((r << W1) >> 8) mod K, and the word
    from the thread's base slot plus the register's."""
    _, w1 = _minor_windows(log2M)
    K = 1 << minor_cluster_log2(log2M)
    r = np.asarray(r)
    base = minor_cluster_inverse_slot(log2M, minor_cluster_point(
        log2M, b, t, 0))
    return ((r << w1) >> 8) & (K - 1), base + minor_cluster_inverse_slot(
        log2M, r << w1)


def minor_cluster_take_inverse(t, r):
    """The word thread t reads into register r of the inverse's top group:
    t + 256·r."""
    return np.asarray(t) + (np.asarray(r) << 8)


_COS16 = np.cos(np.pi * np.arange(8) / 8).astype(np.float32)
_NSIN16 = (-np.sin(np.pi * np.arange(8) / 8)).astype(np.float32)


def minor_cluster_twiddle(log2M: int, w: int, u, q: int, j: int
                          ) -> np.ndarray:
    """The twiddle W_{2^(w+q+1)}^(u mod 2^w + 2^w·j) of the pairs r0 mod
    2^q = j of a stage on register bit q of a group at window w, as
    ``rooted_stage`` forms it (the forward's groups, and the top group of
    both modes): the table entry 2^(w+q) + u mod 2^w (1 at w = 0), times
    -i exactly where 2j = 2^q, else times the f32 constant W_{2^(q+1)}^j
    in one f32 complex product (a constant alone at w = 0), as
    complex64."""
    tw = twiddle_table_plain(1 << log2M).numpy()
    if w:
        base = tw[(1 << (w + q)) + (np.asarray(u) & ((1 << w) - 1))]
        br, bi = base[..., 0], base[..., 1]
    else:
        br, bi = np.float32(1.0), np.float32(0.0)
    if j == 0:
        re, im = br, bi
    elif 2 * j == 1 << q:
        re, im = bi, -br
    else:
        e = j << (3 - q)
        c, s = _COS16[e], _NSIN16[e]
        re = (br * c - bi * s).astype(np.float32)
        im = (br * s + bi * c).astype(np.float32)
    return (np.asarray(re) + 1j * np.asarray(im)).astype(np.complex64)


def minor_cluster_smem_bytes(forward: bool) -> int:
    """A cluster block's shared memory: the tile its peers send into (two
    planes of 4096), and for the inverse one plane more of its own for
    the exchanges before its sends."""
    return 4 * (2 if forward else 3) << MINOR_ROW_LOG2


def minor_cluster_conflicts(log2M: int) -> int:
    """The most words one bank serves in one warp access of the exchange
    through the cluster (M ≥ 8192): the forward's sends (each warp's to
    one block a register) and takes, the inverse's sends and takes. The
    other exchanges are in-block (``exchange_conflicts``)."""
    lk = minor_cluster_log2(log2M)
    worst = 1
    for b in range(1 << lk):
        for warp in range(0, MINOR_THREADS, 32):
            t = np.arange(warp, warp + 32)
            for r in range(PTS):
                accesses = []
                for send in (minor_cluster_send_forward,
                             minor_cluster_send_inverse):
                    dest, word = send(log2M, b, t, r)
                    assert len(set(np.broadcast_to(dest, t.shape).tolist())
                               ) == 1
                    accesses.append(word)
                accesses.append(minor_cluster_point(log2M, 0, t, r))
                accesses.append(minor_cluster_take_inverse(t, r))
                for words in accesses:
                    worst = max(worst, _most_in_a_bank(words))
    return worst


def major_address(col, i, log2C: int):
    """Word of point i of strip column ``col`` in a plane of the major
    exchange tile: rows of C words, one padding row per 16 (as
    ``MajorTile::at``, and ``cluster_word`` at C = 8). At C = 1 (the
    product mode's one-row minor blocks of 16384 points) a warp's 32
    consecutive points meet in one bank once (words 0 and 32): see
    ``exchange_conflicts``."""
    return (i + (i >> 4) << log2C) + col


def _most_in_a_bank(words) -> int:
    """The most distinct words one bank serves in one warp access."""
    banks: dict[int, set[int]] = {}
    for a in words:
        banks.setdefault(int(a) % BANKS, set()).add(int(a))
    return max(len(x) for x in banks.values())


def cluster_conflicts(log2A: int) -> int:
    """The most words one bank serves in one warp access of the cluster
    passes' own shared-memory accesses (A ≥ 8192): the forward's sends
    (each warp's to one block) and takes of the exchange, the inverse's
    sends, and the inverse's reads of its swizzled copy of the strip.
    Their other accesses are A = 2048's (``exchange_conflicts``)."""
    lk = major_cluster_log2(log2A)
    K = 1 << lk
    worst = 1
    for warp in range(0, major_threads(log2A), 32):
        tid = np.arange(warp, warp + 32)
        col, u = tid & 7, tid >> 3
        for r in range(PTS):
            dest, slot = cluster_push_forward(log2A, 1, u, r)
            assert len(set(dest.tolist())) == 1
            accesses = [
                major_address(col, slot, CLUSTER_LOG2C),
                major_address(col, cluster_pull_forward(log2A, u, r),
                              CLUSTER_LOG2C),
                major_address(col, cluster_push_inverse(log2A, 1, u, r)[1],
                              CLUSTER_LOG2C),
                (cluster_inverse_raw_slot(
                    log2A, cluster_stage_row(log2A, 0, u, r))
                 << CLUSTER_LOG2C) + col,
            ]
            for words in accesses:
                worst = max(worst, _most_in_a_bank(words))
    assert K * (2048 // K) == 2048
    return worst


def exchange_conflicts(log2L: int, major: bool,
                       product: bool = False) -> int:
    """The most words one bank serves in a single warp access of any
    exchange of the pass (1: conflict-free), for 4-byte accesses of one
    plane by each register of each warp of a block; on a cluster (A ≥
    8192: its block's A = 2048 exchanges and ``cluster_conflicts``; M ≥
    8192 forward and inverse: its block's exchanges between the groups
    below the top one and ``minor_cluster_conflicts``). 1 for every pass
    but the product mode's one-row blocks of 16384 points, 2 there: their
    padded line, whose steps are immediates (a thread of 1024 has 64
    registers for its 32 points and their 16 addresses)."""
    if major and major_cluster_log2(log2L):
        return max(exchange_conflicts(CLUSTER_BLOCK_LOG2, True),
                   cluster_conflicts(log2L))
    groups = stage_groups(log2L)
    on_cluster = not major and minor_cluster_log2(log2L, product) > 0
    if on_cluster:
        groups = groups[1:]  # the top group's exchange goes through the
        # cluster (minor_cluster_conflicts)
    log2C = major_strip_log2(log2L) if major else 0
    threads = (major_threads(log2L) if major
               else minor_threads(log2L, product))
    T = min(1 << (log2L - LOG2_PTS), threads)  # a minor line's threads
    worst = minor_cluster_conflicts(log2L) if on_cluster else 1
    for w, _, _ in groups:
        for warp in range(0, threads, 32):
            for r in range(PTS):
                banks: dict[int, set[int]] = {}
                for tid in range(warp, warp + 32):
                    if major:
                        col, u = tid & ((1 << log2C) - 1), tid >> log2C
                        a = major_address(col, position(u, r, w), log2C)
                    else:
                        line, u = tid // T, tid % T
                        a = minor_address(line, position(u, r, w), log2L,
                                          product)
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


def cross_root_plain(k, log2n: int, sign: float,
                     split: bool | None = None) -> np.ndarray:
    """The kernels' cross twiddle exp(sign·2πi·k/n) for integer exponents
    ``k`` < n = 2^log2n, as complex64, the way ``root`` in fft_passes.cuh
    forms it: one ``sincospif`` of k·2^(1 - log2n) up to n = 2^24, where
    every k is exact in f32; above, k = hi·2^12 + lo, one ``sincospif`` of
    each part (both exact in f32 after the power-of-two scale) and one f32
    complex product. Each ``sincospif`` is taken as float64 rounded once to
    f32, which the device's is within an ulp of. ``split`` forces the form
    (``root<WIDE>``: the cluster passes split at every n)."""
    k = np.asarray(k, np.int64)

    def one(part, scale_log2):
        arg = np.float32(sign) * np.ldexp(part.astype(np.float32),
                                          scale_log2).astype(np.float32)
        ang = np.pi * arg.astype(np.float64)
        return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)

    if not (log2n > EXACT_LOG2N if split is None else split):
        c, s = one(k, 1 - log2n)
        return (c + 1j * s).astype(np.complex64)
    c1, s1 = one(k >> 12, 13 - log2n)
    c0, s0 = one(k & 4095, 1 - log2n)
    re = c1 * c0 - s1 * s0
    im = c1 * s0 + s1 * c0
    return (re + 1j * im).astype(np.complex64)
