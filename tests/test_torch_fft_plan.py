"""The host side of the CUDA FFT passes' design (``ops/fft_plan.py``).

The kernels run only on a GPU; what they are told and what they assume
is checked here on the CPU: the stage groups of every factor 2^7 to 2^14
cover each radix-2 stage once, the exchange tiles are free of bank
conflicts and fit the block, the twiddle table is the plain one, the
cross twiddle's split exponent above fft_len 2^24 stays within 2 ulp,
and a numpy emulation of the kernels' algorithm (16 registers per thread,
the groups, the exchanges, the twiddle indices of ``run_group``) gives
the plain transforms.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from audio_matcher_tpu_torch.ops import cuda_fft as F  # noqa: E402
from audio_matcher_tpu_torch.ops import fft_plan as P  # noqa: E402

LOG2S = list(range(P.MIN_LOG2, P.MAX_LOG2 + 1))


@pytest.mark.parametrize("b", LOG2S)
def test_stage_groups_cover_every_stage_once(b):
    groups = P.stage_groups(b)
    assert [k for _, _, k in groups] == sorted(
        (k for _, _, k in groups), reverse=True)
    assert all(k in (3, 4) for _, _, k in groups)
    stages = [w + q for w, qlo, k in groups for q in range(qlo, qlo + k)]
    assert sorted(stages) == list(range(b))
    # top bits first, each group's bits below the previous group's
    tops = [w + qlo + k for w, qlo, k in groups]
    assert tops[0] == b and all(x > y for x, y in zip(tops, tops[1:]))
    for w, qlo, k in groups:
        assert 0 <= w <= b - P.LOG2_PTS and qlo + k <= P.LOG2_PTS
    assert groups[0][0] == b - P.LOG2_PTS and groups[-1][0] == 0


@pytest.mark.parametrize("b", [P.MIN_LOG2 - 1, P.MAX_LOG2 + 1])
def test_no_plan_outside_the_factors(b):
    with pytest.raises(ValueError):
        P.stage_groups(b)


@pytest.mark.parametrize("major", [False, True])
@pytest.mark.parametrize("b", LOG2S)
def test_exchange_tiles_have_no_bank_conflicts(b, major):
    """Conflict-free in every major pass (at A = 8192 and 16384 the
    cluster blocks' A = 2048 tiles and the cluster's own accesses) and in
    the forward and inverse minor modes (at M = 8192 and 16384 the cluster
    blocks' 4096-point tiles and the exchange through the cluster); the
    product mode's one row of 16384 (the padded one-column line, one of 32
    words in a shared bank) at most 2-way."""
    assert P.exchange_conflicts(b, major) == 1
    if not major:
        assert P.exchange_conflicts(b, False, product=True) == (
            1 if b < P.MAX_LOG2 else 2)


@pytest.mark.parametrize("b", LOG2S)
def test_tiles_fit_the_block_and_hold_every_point_once(b):
    A = 1 << b
    log2C = P.major_strip_log2(b)
    C = 1 << log2C
    assert P.major_threads(b) <= 1024 and P.major_threads(b) % 32 == 0
    # 4 to 32 columns up to A = 4096; 8 on a cluster's 2048 rows a block
    B = 1 << P.major_block_log2(b)
    assert 4 <= C <= 32 and B << P.major_cluster_log2(b) == A
    assert C * B == 1 << P.MAJOR_TILE_LOG2 or C in (4, 32)
    assert P.major_smem_bytes(b) <= P.MAX_SMEM
    assert P.major_smem_bytes(b, planes=True) <= P.MAX_SMEM
    words = {P.major_address(c, i, log2C) for c in range(C) for i in range(B)}
    assert len(words) == C * B
    assert max(words) < (B + B // 16) * C
    # several blocks an SM, each of a cluster's too (3 within 85 registers)
    assert P.minor_smem_bytes(b) <= 48 * 1024
    if b <= P.WIDE_LOG2:
        assert 3 * P.minor_smem_bytes(b, product=True) <= P.MAX_SMEM
    for product in (False, True):
        threads = P.minor_threads(b, product)
        assert threads <= 1024 and threads % 32 == 0
        assert P.minor_smem_bytes(b, product) <= P.MAX_SMEM
        # a block's lines (on a cluster, its 4096 points of the row)
        points = threads * P.PTS
        lines, length = max(points >> b, 1), min(points, A)
        got = sorted(P.minor_address(line, i, b, product)
                     for line in range(lines) for i in range(length))
        assert len(set(got)) == points
        assert got[-1] < P.minor_tile_words(b, product)
        if not product or b <= P.PADDED_MINOR_LOG2:  # a permutation
            assert got == list(range(points))


@pytest.mark.parametrize("L", [128, 2048, 4096, 16384])
def test_twiddle_table_plain_against_numpy(L):
    tw = P.twiddle_table_plain(L).numpy()
    want = np.ones(L, np.complex128)
    for k in range(1, L):
        m = 1 << (k.bit_length() - 1)
        want[k] = np.exp(-1j * np.pi * (k - m) / m)
    assert np.abs(tw[:, 0] - want.real).max() <= 2.0 ** -24
    assert np.abs(tw[:, 1] - want.imag).max() <= 2.0 ** -24
    assert torch.equal(F.twiddle_table(L, "cpu"), P.twiddle_table_plain(L))


def _positions(b, w):
    u = np.arange(1 << (b - P.LOG2_PTS))
    return np.stack([(u & ((1 << w) - 1)) | (u >> w) << (w + P.LOG2_PTS)
                     | r << w for r in range(P.PTS)], axis=1)


def _emulate(x, b, forward):
    """The kernels' grouped transform of the lines of x (complex64
    [lines, 2^b]) in numpy: thread u holds 16 points, runs the stages of
    its group with the twiddle index of ``run_group``, and the groups
    meet through a scatter and a gather (the exchanges)."""
    tw = P.twiddle_table_plain(1 << b).numpy()
    twc = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    groups = P.stage_groups(b)
    if not forward:
        groups = groups[::-1]
    u = np.arange(1 << (b - P.LOG2_PTS))
    v = x[:, _positions(b, groups[0][0])]
    for g, (w, qlo, k) in enumerate(groups):
        if g:
            line = np.empty_like(x)
            line[:, _positions(b, groups[g - 1][0])] = v
            v = line[:, _positions(b, w)]
        _run_group(v, u, (w, qlo, k), twc, forward)
    out = np.empty_like(x)
    out[:, _positions(b, groups[-1][0])] = v
    return out


def _run_group(v, u, group, twc, forward):
    """One stage group on v ([lines, threads, 16]) in place, thread u's
    twiddles as ``run_group`` indexes them."""
    w, qlo, k = group
    ulo = np.asarray(u) & ((1 << w) - 1)
    qs = range(qlo + k - 1, qlo - 1, -1) if forward else range(qlo, qlo + k)
    for q in qs:
        half = 1 << q
        for r0 in range(P.PTS):
            if r0 & half:
                continue
            r1 = r0 | half
            wv = twc[(1 << (w + q)) + ulo + ((r0 & (half - 1)) << w)]
            a, c = v[:, :, r0].copy(), v[:, :, r1].copy()
            if forward:
                v[:, :, r0], v[:, :, r1] = a + c, (a - c) * wv
            else:
                cw = c * np.conj(wv)
                v[:, :, r0], v[:, :, r1] = a + cw, a - cw


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("b", LOG2S)
def test_grouped_transform_matches_the_plain_passes(b, forward):
    rng = np.random.default_rng(b + 20 * forward)
    x = (rng.standard_normal((3, 1 << b))
         + 1j * rng.standard_normal((3, 1 << b))).astype(np.complex64)
    got = _emulate(x, b, forward)
    xr, xi = torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy())
    plain = F.fft_minor_plain if forward else F.ifft_minor_plain
    yr, yi = plain(xr, xi, 1 << b)
    want = yr.numpy() + 1j * yi.numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("b", LOG2S)
@pytest.mark.parametrize("P_", [1, 3, 8, 512])
def test_every_strip_goes_to_exactly_one_block(P_, b):
    """The persistent major passes: block k walks strips k, k + blocks, ...
    for the card's SMs times the blocks an SM holds (1-4)."""
    for log2M in {b, min(b + 1, P.MAX_LOG2)}:
        strips = P_ << (log2M - P.major_strip_log2(b))
        for blocks in (132, 264, 528, strips):
            walks = P.block_strips(P_, b, log2M, blocks)
            got = sorted(s for walk in walks for s in walk)
            assert got == list(range(strips))
            assert len(walks) == min(blocks, strips)


WIRE_STARTS = [(size, start) for size in (1, 2, 4)
               for start in range(0, 16, size)]


@pytest.mark.parametrize("size,start", WIRE_STARTS)
def test_wire_copy_covers_the_row_bytes_exactly(size, start):
    """Every start alignment a wire row of each dtype can have: the copies
    are aligned at both ends, read the row piece's bytes (f32, and u8 and
    int16 rows that start on 8 bytes, in one copy a row where the piece
    allows it) or exactly the 4-byte words they touch (u8, int16), and fit
    the row's slot."""
    for log2C in range(P.MAJOR_MIN_LOG2C, 6):
        piece = size << log2C
        g, lead, chunks = P.wire_copy(size, log2C, start)
        assert g in (4, 8, 16) and (start - lead) % g == 0
        read = {start - lead + i for i in range(chunks * g)}
        stride = P.wire_stride(size, log2C)
        if size == 4 or start % 8 == 0:
            assert read == set(range(start, start + piece))
            assert lead == 0
            assert size == 4 or g >= min(8, piece)
        else:
            lo, hi = start // 4 * 4, -(-(start + piece) // 4) * 4
            assert read == set(range(lo, hi))
        assert chunks * g <= stride and stride % g == 0
        # the element a thread reads lies in its row's copied bytes
        assert lead + piece <= chunks * g


@pytest.mark.parametrize("size,start", WIRE_STARTS)
def test_wire_copy_of_narrow_strips(size, start):
    """Strips of 1 and 2 columns (the copy rule at every piece; no pass
    takes them since A = 8192 and 16384 run on clusters): f32 pieces (4 or
    8 bytes) copied exactly in chunks no longer than the piece; u8 and
    int16 pieces (1 to 4 bytes) in the 4-byte words they touch, which fit
    the row's slot."""
    for log2C in range(P.MAJOR_MIN_LOG2C):
        piece = size << log2C
        g, lead, chunks = P.wire_copy(size, log2C, start)
        stride = P.wire_stride(size, log2C)
        read = {start - lead + i for i in range(chunks * g)}
        assert g in (4, 8) and (start - lead) % g == 0 and g <= max(piece, 4)
        if size == 4:
            assert lead == 0 and read == set(range(start, start + piece))
        else:
            lo, hi = start // 4 * 4, -(-(start + piece) // 4) * 4
            assert read == set(range(lo, hi)) and lead == start % 4
        assert chunks * g <= stride and stride % 4 == 0
        assert lead + piece <= chunks * g


def test_wide_factors_take_narrow_strips_and_one_row_blocks():
    """A = 8192 and 16384 take strips of 8 columns (whole 32-byte sectors
    of a row) on clusters of 4 and 8 blocks of 2048 rows and 1024 threads,
    no TMA stores (the threads store whole sectors); the forward and
    inverse minor modes at M = 8192 and 16384 a row on a cluster of 2 and
    4 blocks of 256 threads and one 32 KB pair of tiles each, M = 4096's
    block; the product mode there one row of 512 and 1024 threads a
    block, at M = 16384 with no window row beside its two padded tiles."""
    assert [P.major_strip_log2(b) for b in (13, 14)] == [3, 3]
    assert [P.major_cluster_log2(b) for b in (12, 13, 14)] == [0, 2, 3]
    assert [P.major_block_log2(b) for b in (12, 13, 14)] == [12, 11, 11]
    assert [P.major_threads(b) for b in (13, 14)] == [1024, 1024]
    assert [P.minor_cluster_log2(b) for b in (12, 13, 14)] == [0, 1, 2]
    assert [P.minor_cluster_log2(b, product=True)
            for b in (12, 13, 14)] == [0, 0, 0]
    assert [P.minor_threads(b) for b in (12, 13, 14)] == [256, 256, 256]
    assert [P.minor_threads(b, product=True)
            for b in (12, 13, 14)] == [256, 512, 1024]
    for b in (13, 14):
        for size in (1, 2, 4):
            for pair in (False, True):
                assert not P.wire_layout(b, size, pair)["tma"]
        assert P.minor_smem_bytes(b) == P.minor_smem_bytes(12) == 4 * 2 * 4096
    assert P.minor_smem_bytes(13, product=True) == 4 * 4 * 8192
    assert P.minor_smem_bytes(14, product=True) == 4 * 2 * 17408


@pytest.mark.parametrize("log2n", [22, 24, 25, 26, 27, 28])
def test_cross_root_split_exponent_within_two_ulp(log2n):
    """The kernels' cross twiddle W_n^{±k} (``root``), mirrored by
    ``cross_root_plain``: within 2 ulp (of values in [0.5, 1)) of float64
    exp for exponents k up to n - 1 = 2^28 - 1, where a single f32 of k
    is off by up to 2^(log2n - 24) units of k."""
    n = 1 << log2n
    rng = np.random.default_rng(log2n)
    k = np.concatenate([
        np.arange(0, 4097), n - 1 - np.arange(4097),
        rng.integers(0, n, 200_000),
        (1 << np.arange(log2n)) + 1, (1 << np.arange(log2n)) - 1,
    ]).astype(np.int64)
    for sign in (-1.0, 1.0):
        got = P.cross_root_plain(k, log2n, sign)
        want = np.exp(sign * 2j * np.pi * (k.astype(np.float64) / n))
        err = np.abs(got.real - want.real).max(), np.abs(
            got.imag - want.imag).max()
        assert max(err) <= 2 * 2.0 ** -24, err
    if log2n > P.EXACT_LOG2N:  # one f32 of k misses the 2 ulp there
        one = np.exp(-2j * np.pi * k.astype(np.float32).astype(np.float64)
                     / n)
        assert np.abs(one - np.exp(-2j * np.pi * k / n)).max() > 2 * 2.0 ** -24


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("b", LOG2S)
def test_wire_passes_fit_and_read_without_bank_conflicts(b, pair):
    log2C = P.major_strip_log2(b)
    C = 1 << log2C
    for size in (1, 2, 4):
        lay = P.wire_layout(b, size, pair)
        assert lay["smem"] <= P.MAX_SMEM
        assert P.major_smem_bytes(b, elem_size=size, pair=pair) == lay["smem"]
        if size == 1:  # mulaw8: by TMA where rows are half sectors
            assert lay["tma"] == (P.major_strip_log2(b) == 2)
        for lead in range(0, 4, size) if size < 4 else (0,):
            for warp in range(0, P.major_threads(b), 32):
                for r in range(P.PTS):
                    banks: dict[int, set[int]] = {}
                    for tid in range(warp, warp + 32):
                        col, u = tid % C, tid >> log2C
                        a = u + r * ((1 << P.major_block_log2(b)) // P.PTS)
                        word = (a * lay["stride"] + lead + col * size) // 4
                        banks.setdefault(word % P.BANKS, set()).add(word)
                    assert max(len(w) for w in banks.values()) == 1


@pytest.mark.parametrize(
    "b", [b for b in LOG2S if not P.major_cluster_log2(b)])
def test_wire_output_staging_fills_the_boxes_without_bank_conflicts(b):
    """The TMA output of a strip: each warp's writes at each step fall in
    32 banks, the block's writes fill the dense [A, C] plane once, and the
    A / box boxes of each plane (the imaginary one in the exchange tile,
    the real one beside it) start on 128 bytes and tile it; one warp
    starts them."""
    A, C = 1 << b, 1 << P.major_strip_log2(b)
    seen = np.zeros(A * C, np.int32)
    for warp in range(0, P.major_threads(b), 32):
        for r in range(P.PTS):
            words = [P.stage_word(b, tid, r) for tid in range(warp, warp + 32)]
            assert len({w % P.BANKS for w in words}) == 32
            for w in words:
                seen[w] += 1
    assert (seen == 1).all()
    box = P.wire_box(b)
    tile = P.wire_layout(b, 1, True)["tile"]  # where TMA: the real stage
    starts = [base + a0 * C * 4 for base in (0, tile)
              for a0 in range(0, A, box)]
    assert len(starts) == 2 * A // box and A // box <= 32
    assert all(x % 128 == 0 for x in starts) and box <= 256


# ------------------------------------------------------ the cluster passes
CLUSTER_LOG2S = [13, 14]  # A = 8192 and 16384
SIM_LOG2M = 7  # M = 128: n = 2^20 and 2^21, small enough for numpy


def _sim_input(log2A, planes, seed):
    rng = np.random.default_rng(seed)
    shape = (planes, 1 << log2A, 1 << SIM_LOG2M)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _threads():
    """Thread u (v) and register r of a cluster block, as [128, 16]."""
    return np.arange(128)[:, None], np.arange(P.PTS)[None, :]


def _inner(log2A, b, sign):
    """The inner twiddle of position (u << 4) | r of block b, as the
    kernels form it: it[u] * it[128 + brev_4(r)] (``build_inner``)."""
    u, r = _threads()
    base = P.cross_root_plain(b * P.brev(u << 4, 11), log2A, sign, False)
    tab = P.cross_root_plain(b * (np.arange(P.PTS) << 7), log2A, sign, False)
    return (base * tab[P.brev(r, 4)]).astype(np.complex64)


def _cross(log2A, b, sign):
    """The cross twiddle of register r of thread v of block b in the
    K-point stage, column c: base(v, c) * ct[c][r], [128, 16, M]."""
    v, r = _threads()
    lk = P.major_cluster_log2(log2A)
    log2n = log2A + SIM_LOG2M
    c = np.arange(1 << SIM_LOG2M)
    base = P.cross_root_plain(
        P.brev((b << (11 - lk)) + v, 11) * c[None, :], log2n, sign, True)
    tab = P.cross_root_plain(
        P.cluster_cross_exponent(log2A, r)[0][:, None] * c[None, :], log2n,
        sign, True)
    return (base[:, None, :] * tab[None, :, :]).astype(np.complex64)


def _simulate_forward(x, log2A):
    """The forward cluster pass on complex64 [planes, A, M] with numpy,
    through fft_plan's index maps: each block's 2048-point DIF (position
    r1 holds k1 = brev(r1)), the inner twiddle, the sends and takes of the
    exchange, the K-point DIF in registers, the cross twiddle, the
    stores."""
    planes, A, M = x.shape
    lk = P.major_cluster_log2(log2A)
    K = 1 << lk
    u, r = _threads()
    tiles = np.zeros((K, 2048, planes, M), np.complex64)
    for b in range(K):
        rows = P.cluster_forward_row(log2A, b, np.arange(2048))
        Y = np.fft.fft(x[:, rows, :], axis=1)[:, P.brev(np.arange(2048), 11)]
        Y = Y[:, (u << 4) | r, :] * _inner(log2A, b, -1.0)[None, :, :, None]
        dest, slot = P.cluster_push_forward(log2A, b, u, r)
        tiles[dest, slot] = Y.transpose(1, 2, 0, 3)
    out = np.zeros_like(x)
    for b in range(K):
        z = tiles[b][P.cluster_pull_forward(log2A, u, r)]  # [128, 16, p, M]
        z = z.reshape(128, P.PTS >> lk, K, planes, M)
        z = np.fft.fft(z, axis=2)[:, :, P.brev(np.arange(K), lk)]
        z = z.reshape(128, P.PTS, planes, M) * _cross(log2A, b, -1.0)[
            :, :, None, :]
        out[:, P.cluster_stage_row(log2A, b, u, r), :] = z.transpose(
            2, 0, 1, 3)
    return out


def _simulate_inverse(x, log2A, a_crop):
    """The inverse cluster pass with numpy through fft_plan's maps: the
    swizzled copy of each block's 2048 physical rows, the conjugate cross
    twiddle, the K-point inverse, the exchange, the conjugate inner
    twiddle, the 2048-point inverse and the cropped stores."""
    planes, A, M = x.shape
    lk = P.major_cluster_log2(log2A)
    K = 1 << lk
    u, r = _threads()
    tiles = np.zeros((K, 2048, planes, M), np.complex64)
    for b in range(K):
        rho = np.arange(2048)
        raw = np.empty((2048, planes, M), np.complex64)
        raw[P.cluster_inverse_raw_slot(log2A, rho)] = x[
            :, (b << 11) + rho, :].transpose(1, 0, 2)
        rows = P.cluster_stage_row(log2A, b, u, r) - (b << 11)
        z = raw[P.cluster_inverse_raw_slot(log2A, rows)]  # [128, 16, p, M]
        z = z * _cross(log2A, b, 1.0)[:, :, None, :]
        z = z.reshape(128, P.PTS >> lk, K, planes, M)
        z = z[:, :, P.brev(np.arange(K), lk)]  # natural k2
        z = np.fft.ifft(z, axis=2, norm="forward")
        dest, slot = P.cluster_push_inverse(log2A, b, u, r)
        tiles[dest, slot] = z.reshape(128, P.PTS, planes, M)
    out = np.zeros((planes, a_crop, M), np.complex64)
    for b in range(K):
        V = tiles[b][(u << 4) | r] * _inner(log2A, b, 1.0)[:, :, None, None]
        line = np.empty((2048, planes, M), np.complex64)
        line[P.brev((u << 4) | r, 11)] = V  # position p holds brev(p)
        y = np.fft.ifft(line, axis=0, norm="forward")
        rows = P.cluster_inverse_row(log2A, b, u, r)
        keep = rows < a_crop
        out[:, rows[keep], :] = y[(u + (r << 7))[keep]].transpose(1, 0, 2)
    return out


@pytest.mark.parametrize("log2A", CLUSTER_LOG2S)
def test_cluster_forward_decomposition_matches_plain(log2A):
    """The cluster decomposition at A = 8192 and 16384 (M = 128) gives
    ``fft_major_forward_plain``'s scrambled rows: within 1e-5 of the
    largest value, the kernels' tolerance against their plain versions
    (two f32 FFT algorithms on the same input)."""
    x = _sim_input(log2A, 2, log2A)
    got = _simulate_forward(x, log2A)
    A, M = x.shape[1:]
    yr, yi = F.fft_major_forward_plain(
        torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy()),
        A, A * M)
    want = yr.numpy() + 1j * yi.numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("a_crop", ["1", "half", "all"])
@pytest.mark.parametrize("log2A", CLUSTER_LOG2S)
def test_cluster_inverse_decomposition_matches_plain(log2A, a_crop):
    """The inverse cluster decomposition, cropped to a_crop = 1, A/2 + 8
    and A rows, gives ``fft_major_plain``'s rows within 1e-5 of the
    largest value (as the forward's)."""
    x = _sim_input(log2A, 1, log2A + 100)
    A, M = x.shape[1:]
    crop = {"1": 1, "half": A // 2 + 8, "all": A}[a_crop]
    got = _simulate_inverse(x, log2A, crop)
    yr, yi = F.fft_major_plain(
        torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy()),
        A, A * M, crop)
    want = yr.numpy() + 1j * yi.numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("log2A", CLUSTER_LOG2S)
def test_cluster_maps_move_every_point_once_in_whole_sectors(log2A):
    """Every block's copy reads each of its rows once (all A rows over the
    cluster), the exchange fills each slot of each block's tile once each
    way, the K-point stage holds each physical row once, the inverse
    writes each natural row once, and a warp's stores at each register are
    whole 32-byte row pieces (8 columns of 4 rows)."""
    lk = P.major_cluster_log2(log2A)
    K, A = 1 << lk, 1 << log2A
    u, r = _threads()
    fwd_rows = np.concatenate([P.cluster_forward_row(log2A, b, np.arange(
        2048)) for b in range(K)])
    assert sorted(fwd_rows.tolist()) == list(range(A))
    assert sorted(P.cluster_inverse_raw_slot(
        log2A, np.arange(2048)).tolist()) == list(range(2048))
    for push in (P.cluster_push_forward, P.cluster_push_inverse):
        seen = np.zeros((K, 2048), int)
        for b in range(K):
            dest, slot = push(log2A, b, u, r)
            np.add.at(seen, (np.broadcast_to(dest, slot.shape), slot), 1)
        assert (seen == 1).all()
    for b in range(K):
        pulled = P.cluster_pull_forward(log2A, u, r)
        assert sorted(pulled.ravel().tolist()) == list(range(2048))
    stage = np.concatenate([P.cluster_stage_row(log2A, b, u, r).ravel()
                            for b in range(K)])
    assert sorted(stage.tolist()) == list(range(A))
    natural = np.concatenate([P.cluster_inverse_row(log2A, b, u, r).ravel()
                              for b in range(K)])
    assert sorted(natural.tolist()) == list(range(A))
    for warp in range(0, 1024, 32):
        tid = np.arange(warp, warp + 32)
        for reg in range(P.PTS):
            rows = P.cluster_stage_row(log2A, 1, tid >> 3, reg)
            words = (rows << SIM_LOG2M) + (tid & 7)  # c0 = 0
            sectors = {w // 8 for w in words.tolist()}
            assert len(sectors) == 4 and len(set(words.tolist())) == 32


# ------------------------------------ the minor pass's rows on clusters
MINOR_CLUSTER_LOG2S = [13, 14]  # M = 8192 and 16384


def _emulate_minor_cluster(x, log2M, forward):
    """The forward or inverse minor pass on a cluster, on complex64
    [lines, M] in numpy through fft_plan's maps: the top group on thread
    U = 256·b + t of the cluster, the sends into each block's tile and the
    takes, and the other groups on each block's 4096 points with the
    in-block exchanges through the swizzled tile (``minor_address``), each
    group with the kernel's twiddles (``minor_cluster_twiddle``, the
    inverse's lower groups the table's)."""
    lines, M = x.shape
    K = 1 << P.minor_cluster_log2(log2M)
    groups = P.stage_groups(log2M)
    tw = P.twiddle_table_plain(M).numpy()
    twc = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    t, r = np.arange(256)[:, None], np.arange(P.PTS)[None, :]
    tiles = np.zeros((lines, K, 4096), np.complex64)
    out = np.empty_like(x)

    def block_groups(v, order):
        """The groups below the top one in ``order`` on a block's points,
        an exchange through its tile between each two."""
        for g, grp in enumerate(order):
            if g:
                tile = np.empty((lines, 4096), np.complex64)
                tile[:, P.minor_address(0, P.position(
                    t, r, order[g - 1][0]), log2M)] = v
                v = tile[:, P.minor_address(0, P.position(t, r, grp[0]),
                                            log2M)]
            if forward:  # rooted twiddles; the inverse's from the table
                _run_rooted_group(v, log2M, t[:, 0], grp, True)
            else:
                _run_group(v, t[:, 0], grp, twc, False)
        return v

    for b in range(K):
        U = (b << 8) | np.arange(256)
        if forward:
            v = x[:, P.minor_cluster_top(log2M, b, t, r)]
            _run_rooted_group(v, log2M, U, groups[0], True)
            dest, word = P.minor_cluster_send_forward(log2M, b, t, r)
        else:
            v = x[:, (b << 12) + P.position(t, r, 0)]  # 16 consecutive
            v = block_groups(v, groups[:0:-1])
            dest, word = P.minor_cluster_send_inverse(log2M, b, t, r)
        tiles[:, np.broadcast_to(dest, word.shape), word] = v
    for b in range(K):
        if forward:
            v = tiles[:, b, P.minor_cluster_point(log2M, 0, t, r)]
            v = block_groups(v, groups[1:])
            out[:, (b << 12) + P.position(t, r, 0)] = v
        else:
            v = tiles[:, b, P.minor_cluster_take_inverse(t, r)]
            _run_rooted_group(v, log2M, (b << 8) | np.arange(256),
                              groups[0], False)
            out[:, P.minor_cluster_top(log2M, b, t, r)] = v
    return out


def _run_rooted_group(v, log2M, u, group, forward):
    """A group's stages on v ([lines, threads, 16]) in place, with the
    twiddles ``rooted_stage`` forms (``minor_cluster_twiddle``)."""
    w, qlo, k = group
    qs = range(qlo + k - 1, qlo - 1, -1) if forward else range(qlo, qlo + k)
    for q in qs:
        half = 1 << q
        for j in range(half):
            wv = P.minor_cluster_twiddle(log2M, w, u, q, j)
            for r0 in range(j, P.PTS, 2 * half):
                r1 = r0 | half
                a, c = v[:, :, r0].copy(), v[:, :, r1].copy()
                if forward:
                    v[:, :, r0], v[:, :, r1] = a + c, (a - c) * wv
                else:
                    cw = c * np.conj(wv)
                    v[:, :, r0], v[:, :, r1] = a + cw, a - cw


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("log2M", MINOR_CLUSTER_LOG2S)
def test_minor_cluster_decomposition_matches_plain(log2M, forward):
    """The rows on clusters at M = 8192 and 16384, forward and inverse,
    give ``fft_minor_plain`` and ``ifft_minor_plain`` within 1e-5 of the
    largest value, the kernels' tolerance against their plain versions."""
    rng = np.random.default_rng(log2M + 40 * forward)
    x = (rng.standard_normal((3, 1 << log2M))
         + 1j * rng.standard_normal((3, 1 << log2M))).astype(np.complex64)
    got = _emulate_minor_cluster(x, log2M, forward)
    plain = F.fft_minor_plain if forward else F.ifft_minor_plain
    yr, yi = plain(torch.from_numpy(x.real.copy()),
                   torch.from_numpy(x.imag.copy()), 1 << log2M)
    want = yr.numpy() + 1j * yi.numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("log2M", MINOR_CLUSTER_LOG2S)
def test_minor_cluster_maps_move_every_point_once(log2M):
    """The top group's points and the blocks' points each cover the row
    once; each send fills every word of every block's tile once; each
    block's takes read its 4096 words once; the inverse's base-plus-
    register form of a word is the slot of the point it sends, and its
    block is the point's; a warp's loads and stores of the top group and
    the forward's float4 stores are whole sectors."""
    M = 1 << log2M
    K = 1 << P.minor_cluster_log2(log2M)
    t, r = np.arange(256)[:, None], np.arange(P.PTS)[None, :]
    for index in (P.minor_cluster_top, P.minor_cluster_point):
        got = np.concatenate([np.broadcast_to(index(log2M, b, t, r),
                                              (256, P.PTS)).ravel()
                              for b in range(K)])
        assert sorted(got.tolist()) == list(range(M))
    for send in (P.minor_cluster_send_forward, P.minor_cluster_send_inverse):
        seen = np.zeros((K, 4096), int)
        for b in range(K):
            dest, word = send(log2M, b, t, r)
            np.add.at(seen, (np.broadcast_to(dest, word.shape), word), 1)
        assert (seen == 1).all()
    for take in (P.minor_cluster_point(log2M, 0, t, r),
                 P.minor_cluster_take_inverse(t, r)):
        assert sorted(take.ravel().tolist()) == list(range(4096))
    for b in range(K):
        g = P.minor_cluster_point(log2M, b, t, r)
        dest, word = P.minor_cluster_send_inverse(log2M, b, t, r)
        assert (np.broadcast_to(dest, g.shape) == (g >> 8) % K).all()
        assert (word == P.minor_cluster_inverse_slot(log2M, g)).all()
        # the point arrives where its top-group thread takes it
        top_t, top_r = g & 255, g >> (log2M - P.LOG2_PTS)
        assert (word == P.minor_cluster_take_inverse(top_t, top_r)).all()
        fwd_dest, fwd_word = P.minor_cluster_send_forward(log2M, b, t, r)
        top = P.minor_cluster_top(log2M, b, t, r)
        assert (np.broadcast_to(fwd_dest, top.shape) == top >> 12).all()
        assert (fwd_word == top % 4096).all()
        for warp in range(0, 256, 32):
            words = top[warp:warp + 32]  # [32, 16]: a register's 32 lanes
            assert all(len({w // 8 for w in words[:, k].tolist()}) == 4
                       for k in range(P.PTS))


@pytest.mark.parametrize("log2M", MINOR_CLUSTER_LOG2S)
def test_minor_cluster_rooted_twiddles_and_blocks_fit(log2M):
    """The rooted twiddles (a table entry times a constant, each rounded
    to f32, then their rounded product) of every group of the forward and
    of the top group are within 3·2^-24 of exp(-2πi·k/2^(w+q+1)); a
    cluster block's shared memory lets 4 blocks share an SM (64 registers
    a thread), the inverse's own plane included."""
    u = np.arange(1 << (log2M - P.LOG2_PTS))
    for w, qlo, k in P.stage_groups(log2M):
        for q in range(qlo, qlo + k):
            for j in range(1 << q):
                got = P.minor_cluster_twiddle(log2M, w, u, q, j)
                e = (u & ((1 << w) - 1)) + (j << w)
                want = np.exp(-2j * np.pi * e / 2.0 ** (w + q + 1))
                assert np.abs(got - want).max() <= 3 * 2.0 ** -24
    for forward in (True, False):
        smem = P.minor_cluster_smem_bytes(forward)
        assert P.MINOR_CLUSTER_BLOCKS * smem <= P.MAX_SMEM
    assert P.minor_cluster_smem_bytes(True) == P.minor_smem_bytes(log2M)

