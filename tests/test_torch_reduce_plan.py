"""The host side of the CUDA peak reduction (``ops/cuda_kernels.py``).

The kernel (``csrc/block_reduce.cu``) runs only on a GPU; its geometry is
checked here on the CPU: the per-tile seam and validity rule it applies
gives the plain version's per-column rule, and its launch gives every
(row, tile) to exactly one warp.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from audio_matcher_tpu_torch.ops import cuda_kernels as K  # noqa: E402

SMS = 132  # an H100's SMs
VALID_CASES = ("0", "1", "2", "block-1", "block+1", "seg-1", "seg+1", "V",
               "V+1")


def _valid_len(case: str, block: int, seg: int, V: int) -> int:
    return eval(case, {}, {"block": block, "seg": seg, "V": V})


def _plain_rule(V: int, block: int, vl: int):
    """The plain version's per-column masks (``_reduce_plain``)."""
    cols = torch.arange(V)
    in_seg = cols % (K.GROUP * block)
    seg_inner = (in_seg != 0) & (in_seg != K.GROUP * block - 1)
    colvalid = cols < vl
    return colvalid, (cols >= 1) & (cols <= vl - 2) & seg_inner & colvalid


@pytest.mark.parametrize("case", VALID_CASES)
@pytest.mark.parametrize("block", K.BLOCKS)
def test_per_tile_rule_is_the_plain_per_column_rule(block, case):
    seg = K.GROUP * block
    for V in (5 * block, seg, 2 * seg + 3 * block, 3 * seg):
        vl = _valid_len(case, block, seg, V)
        valid, cand = zip(*(K.tile_columns(t, block, vl)
                            for t in range(V // block)))
        want_valid, want_cand = _plain_rule(V, block, vl)
        assert torch.equal(torch.cat(valid), want_valid), (V, vl)
        assert torch.equal(torch.cat(cand), want_cand), (V, vl)


@pytest.mark.parametrize("block", K.BLOCKS)
def test_a_full_tile_masks_only_its_seams(block):
    """The kernel skips the masks of a tile with valid_len - base > block:
    every column is valid and a candidate but for a seam."""
    for t in (0, 1, K.GROUP - 1, K.GROUP, 3 * K.GROUP - 1):
        valid, cand = K.tile_columns(t, block, t * block + block + 1)
        assert valid.all()
        seams = {0} if t % K.GROUP == 0 else set()
        if t % K.GROUP == K.GROUP - 1:
            seams.add(block - 1)
        assert set(torch.nonzero(~cand).flatten().tolist()) == seams


@pytest.mark.parametrize("nb", [1, 2, 5, 17, 1000, 5504])
@pytest.mark.parametrize("rows", [1, 3, 8, 512])
def test_every_tile_goes_to_exactly_one_warp(rows, nb):
    run, runs, blocks = K.reduce_grid(rows, nb, SMS)
    assert 1 <= run <= K.MAX_RUN and run & (run - 1) == 0
    if run > 1:  # the runs were lengthened only while WAVES waves remained
        assert rows * runs >= K.WAVES * SMS * K.SM_WARPS
    seen = np.zeros((rows, nb), np.int32)
    for w in range(blocks * K.WARPS):
        got = K.warp_tiles(w, rows, nb, run, runs)
        if got is None:
            continue
        row, t0, t1 = got
        assert 0 <= t0 < t1 <= nb and t1 - t0 <= run
        seen[row, t0:t1] += 1
    assert (seen == 1).all()


def test_the_wrappers_refuse_what_the_kernel_cannot_index():
    x = torch.zeros((1, 512))
    with pytest.raises(ValueError, match="block"):
        K._launchable((x,), 384)
    wide = torch.zeros(1).expand(1, K.MAX_V + 1)
    with pytest.raises(ValueError, match="columns"):
        K._launchable((wide,), 512)
    # no row cap: the grid is 1-D over warps; 65537 rows of one tile
    K._launchable((torch.zeros((65537, 512)),), 512)
    assert not hasattr(K, "MAX_ROWS")
    run, runs, blocks = K.reduce_grid(65537, 1, SMS)
    assert blocks * K.WARPS >= 65537 * runs and blocks < 1 << 31
