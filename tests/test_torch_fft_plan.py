"""The host side of the CUDA FFT passes' design (``ops/fft_plan.py``).

The kernels run only on a GPU; what they are told and what they assume
is checked here on the CPU: the stage groups of every factor 2^7 to 2^12
cover each radix-2 stage once, the exchange tiles are free of bank
conflicts and fit the block, the twiddle table is the plain one, and a
numpy emulation of the kernels' algorithm (16 registers per thread, the groups, the exchanges,
the twiddle indices of ``run_group``) gives the plain transforms.
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


@pytest.mark.parametrize("b", [6, 13])
def test_no_plan_outside_the_factors(b):
    with pytest.raises(ValueError):
        P.stage_groups(b)


@pytest.mark.parametrize("major", [False, True])
@pytest.mark.parametrize("b", LOG2S)
def test_exchange_tiles_have_no_bank_conflicts(b, major):
    assert P.exchange_conflicts(b, major) == 1


@pytest.mark.parametrize("b", LOG2S)
def test_tiles_fit_the_block_and_hold_every_point_once(b):
    A = 1 << b
    log2C = P.major_strip_log2(b)
    C = 1 << log2C
    assert P.major_threads(b) <= 1024 and P.major_threads(b) % 32 == 0
    assert 4 <= C <= 32
    assert C * A == 1 << P.MAJOR_TILE_LOG2 or C in (4, 32)
    assert P.major_smem_bytes(b) <= P.MAX_SMEM
    assert P.major_smem_bytes(b, planes=True) <= P.MAX_SMEM
    words = {P.major_address(c, i, log2C) for c in range(C) for i in range(A)}
    assert len(words) == C * A
    assert max(words) < (A + A // 16) * C
    assert P.minor_smem_bytes() <= 48 * 1024
    assert 3 * P.minor_smem_bytes(product=True) <= P.MAX_SMEM
    lines = P.MINOR_THREADS * P.PTS >> b
    got = sorted(P.minor_address(line, i, b)
                 for line in range(lines) for i in range(A))
    assert got == list(range(P.MINOR_THREADS * P.PTS))


@pytest.mark.parametrize("L", [128, 2048, 4096])
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
        ulo = u & ((1 << w) - 1)
        qs = range(qlo + k - 1, qlo - 1, -1) if forward else range(
            qlo, qlo + k)
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
    out = np.empty_like(x)
    out[:, _positions(b, groups[-1][0])] = v
    return out


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
