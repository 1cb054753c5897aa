"""The port's peak picking against the JAX package's.

The block reductions' plain versions (what the wrapper runs on a CPU
tensor) must equal ``local_max_block_reduce_packed`` and
``local_max_block_reduce`` in Pallas interpret mode exactly: the same f32
products, compared and reduced, with the same seam contract and
argmax-first ties. ``pick_peaks_packed`` and
``pick_peaks_dense`` must then equal ``pick_peaks_pallas_packed`` and
``pick_peaks_pallas`` on the same rows, also exactly (positions,
heights and prominences are selections and f32 differences of the same
plane values). The multi-pass ``"jnp"`` picker (``pick_peaks_core``) is
held against the JAX package's the same way, bit for bit, and
``find_peaks_device`` on both of its branches.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from audio_matcher_tpu.ops.pallas_kernels import (  # noqa: E402
    GROUP as JAX_GROUP,
    local_max_block_reduce as jax_dense_reduce,
    local_max_block_reduce_packed as jax_reduce,
)
from audio_matcher_tpu.ops import peaks as JP  # noqa: E402
from audio_matcher_tpu.ops.peaks import (  # noqa: E402
    peaks_crop_width as jax_crop_width,
    pick_peaks_pallas,
    pick_peaks_pallas_packed,
)

from audio_matcher_tpu_torch.ops.cuda_kernels import (  # noqa: E402
    GROUP,
    _logical_rows,
    local_max_block_reduce,
    local_max_block_reduce_packed,
)
from audio_matcher_tpu_torch.ops import peaks as TP  # noqa: E402
from audio_matcher_tpu_torch.ops.peaks import (  # noqa: E402
    peaks_crop_width,
    pick_peaks_dense,
    pick_peaks_dispatch,
    pick_peaks_packed,
)

SEG = 512 * GROUP  # columns per segment of the reduction


def _planes(seed, P, V):
    rng = np.random.default_rng(seed)
    yr = rng.standard_normal((P, V)).astype(np.float32)
    yi = rng.standard_normal((P, V)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, 2 * P).astype(np.float32)
    return yr, yi, scale


def _plant_edge_cases(yr, yi):
    V = yr.shape[1]
    yr[0, 1000:1010] = 6.0  # a plateau: never a strict peak
    yr[0, 3000] = yr[0, 3100] = 7.0  # equal peaks in one tile: lower wins
    yi[0, 4000:4600:2] = 5.0  # many equal peaks across a tile edge
    if V > 2 * SEG:
        yr[0, SEG - 1] = 9.0  # the blind columns at a segment seam
        yr[0, SEG] = 9.5
        yi[1 % yi.shape[0], 2 * SEG] = 8.0
        yr[0, SEG - 200] = 9.5  # ties with the seam column
    return yr, yi


def _plant_seam_ties(yr, yi):
    """Equal heights in different tiles and across a seam on the second
    logical pair (rows 2 and 3), beside _plant_edge_cases' on row 0."""
    if yr.shape[1] > 2 * SEG:
        yr[1, SEG - 1] = yr[1, SEG - 200] = 9.5  # a seam column ties its tile
        yi[1, SEG] = yi[1, 2 * SEG + 3] = 9.0  # ... and a tile a segment on
    return yr, yi


def _both_reduce(yr, yi, scale, valid, block=512):
    want = jax_reduce(
        jnp.asarray(yr), jnp.asarray(yi), jnp.asarray(scale),
        jnp.asarray(valid), block=block, interpret=True,
    )
    got = local_max_block_reduce_packed(
        torch.from_numpy(yr), torch.from_numpy(yi), torch.from_numpy(scale),
        torch.from_numpy(valid), block,
    )
    return got, want


def test_group_matches():
    assert GROUP == JAX_GROUP


@pytest.mark.parametrize(
    "P,V,valid",
    [
        # multi-segment rows (NB = 300 > GROUP), a valid_len-0 row, a
        # row cut mid-tile, one cut just past a seam
        (2, 512 * 300, lambda V: [V, 0, V - 7, SEG + 1]),
        # a single segment, valid lengths near the row's ends
        (3, 512 * 40, lambda V: [V, 2, 3, V - 1, 0, 600]),
    ],
)
def test_block_reduce_plain_equals_jax_kernel(P, V, valid):
    yr, yi, scale = _planes(P * V, P, V)
    yr, yi = _plant_edge_cases(yr, yi)
    vl = np.asarray(valid(V), np.int32)
    got, want = _both_reduce(yr, yi, scale, vl)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    # a valid_len-0 row emits nothing
    zero = int(np.flatnonzero(vl == 0)[0])
    assert np.all(np.isneginf(got[0][zero].numpy()))


def test_block_reduce_narrow_tiles():
    yr, yi, scale = _planes(9, 2, 256 * 140)
    vl = np.asarray([256 * 140, 256 * 139 + 5, 0, 9000], np.int32)
    got, want = _both_reduce(yr, yi, scale, vl, block=256)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_block_reduce_rejects_bad_shapes():
    x = torch.zeros((2, 1000))
    with pytest.raises(ValueError):
        local_max_block_reduce_packed(x, x, torch.ones(4), torch.ones(4), 512)
    x = torch.zeros((2, 1024))
    with pytest.raises(ValueError):
        local_max_block_reduce_packed(x, x, torch.ones(3), torch.ones(4), 512)


@pytest.mark.parametrize(
    "P,V,distance,n_peaks",
    [
        (2, 512 * 300, 5000, 4),  # seams repaired, mid-tile suppression
        (3, 512 * 32, 700, 6),
        (2, 512 * 260, 1, 3),  # distance 1: nothing suppressed
        (2, 512 * 20, 10**7, 3),  # one pick empties the row
        (2, 512 * 300, 100, 24),  # many rounds, rescans inside a tile
        (3, 512 * 300, 5000, 6),  # seam ties on rows 0 and 1
        (3, 512 * 300, 100, 64),  # many rounds and rescans
        (3, 512 * 300, 40 * 512 + 17, 12),  # intervals over many tiles
        (3, 512 * 20, 10**7, 3),  # slots exhausted, a valid_len-0 row
    ],
)
def test_pick_peaks_packed_equals_jax(P, V, distance, n_peaks):
    yr, yi, scale = _planes(V + distance, P, V)
    yr, yi = _plant_edge_cases(yr, yi)
    if P > 2:
        yr, yi = _plant_seam_ties(yr, yi)
    vl = np.asarray([V, V - 3000, 0, V - 7, V, 5][: 2 * P], np.int32)
    want = pick_peaks_pallas_packed(
        jnp.asarray(yr), jnp.asarray(yi), jnp.asarray(scale),
        jnp.asarray(vl), distance, n_peaks, 2048, interpret=True,
    )
    got = pick_peaks_packed(
        torch.from_numpy(yr), torch.from_numpy(yi), torch.from_numpy(scale),
        torch.from_numpy(vl), distance, n_peaks, 2048,
    )
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2 * P, n_peaks)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the plain reduction selected explicitly gives the same picks
    again = pick_peaks_packed(
        torch.from_numpy(yr), torch.from_numpy(yi), torch.from_numpy(scale),
        torch.from_numpy(vl), distance, n_peaks, 2048, plain=True,
    )
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("mode", ["packed", "dense"])
@pytest.mark.parametrize(
    "V,distance,n_peaks",
    [
        (512 * 300, 5000, 6),  # seam ties, equal heights across tiles
        (512 * 300, 100, 64),  # many rounds and rescans
        (512 * 300, 40 * 512 + 17, 12),  # intervals over many tiles
        (512 * 20, 10**7, 3),  # one pick empties the row: slots exhausted
    ],
)
def test_single_read_pickers_equal_the_multi_pass_picker(mode, V, distance,
                                                         n_peaks):
    """An extra check beside the JAX comparisons above: the plain
    single-read pickers against the port's multi-pass ``pick_peaks_core``,
    which walks the whole rows: heights and prominences bit for bit in
    every slot, positions in every found slot (an exhausted slot's position
    is each picker's own); rows with valid_len 0 and cut mid-tile."""
    P = 3
    yr, yi, scale = _planes(V + distance + n_peaks, P, V)
    yr, yi = _plant_seam_ties(*_plant_edge_cases(yr, yi))
    vl = torch.tensor([V, V - 3000, 0, V - 7, 600, 0])
    t = [torch.from_numpy(a) for a in (yr, yi, scale)]
    x = _logical_rows(*t)
    if mode == "packed":
        got = pick_peaks_packed(*t, vl, distance, n_peaks, 2048)
    else:
        got = pick_peaks_dense(x, vl, distance, n_peaks, 2048)
    want = TP.pick_peaks_core(x, vl, distance, n_peaks, 1024)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    found = torch.isfinite(want[1])
    assert torch.equal(got[0][found], want[0][found])
    assert not found[2].any() and not found[5].any()
    if distance > V:
        assert not found[:, 1:].any()
    else:
        assert found[0].sum() > 2


def test_crop_width_matches():
    for valid in (1, 8003, 65536, 65537, 2_800_353):
        for block in (256, 512, 2048):
            for impl in ("pallas", "jnp"):
                assert peaks_crop_width(valid, block, impl) == jax_crop_width(
                    valid, block, impl
                )
    with pytest.raises(ValueError):
        z = torch.zeros((1, 700))
        pick_peaks_packed(z, z, torch.ones(2), torch.ones(2), 10, 2, 512)


def _dense(seed, B, V, block):
    x = np.random.default_rng(seed).standard_normal((B, V)).astype(np.float32)
    seg = block * GROUP  # columns per segment of the reduction
    x[0, 700:710] = 6.0  # a plateau
    x[0, 1000] = x[0, 1100] = 7.0  # equal peaks in one tile: lower wins
    x[1, seg - 1], x[1, seg] = 9.0, 9.5  # the blind seam columns
    x[2, seg - 60] = 9.5  # ties with a seam column
    return x


@pytest.mark.parametrize("block", [128, 512])
def test_dense_block_reduce_plain_equals_jax_kernel(block):
    """Kernel 7's plain version against the Pallas dense reduction, with
    seams (V = 2·128·block) and valid lengths cut mid-tile."""
    B, V = 5, 2 * GROUP * block
    x = _dense(block, B, V, block)
    vl = np.asarray([V, V - 7, GROUP * block + 3, 0, 300], np.int32)
    want = jax_dense_reduce(
        jnp.asarray(x), jnp.asarray(vl), block=block, interpret=True
    )
    got = local_max_block_reduce(
        torch.from_numpy(x), torch.from_numpy(vl), block
    )
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    assert np.all(np.isneginf(got[0][3].numpy()))
    with pytest.raises(ValueError):
        local_max_block_reduce(torch.zeros((2, 1000)), torch.ones(2), 512)
    with pytest.raises(ValueError):
        local_max_block_reduce(torch.zeros((2, 1024)), torch.ones(3), 512)


@pytest.mark.parametrize(
    "B,V,distance,n_peaks",
    [
        (3, 512 * 300, 5000, 4),  # seams repaired, mid-tile suppression
        (4, 4096, 700, 6),  # the fallback's crop: one segment
        (2, 4000, 300, 3),  # V off the tile grid: zero-padded
        (3, 512 * 300, 100, 64),  # many rounds and rescans
        (3, 512 * 300, 40 * 512 + 17, 12),  # intervals over many tiles
        (3, 512 * 20, 10**7, 3),  # slots exhausted, a valid_len-0 row
    ],
)
def test_pick_peaks_dense_equals_jax(B, V, distance, n_peaks):
    x = _dense(V + distance, B, V, 512) if V > SEG else (
        np.random.default_rng(V).standard_normal((B, V)).astype(np.float32)
    )
    if V > 2 * SEG:  # equal heights in other tiles and across a seam
        x[0, SEG - 1] = x[0, SEG - 200] = 9.5
        x[2, SEG] = x[2, 2 * SEG + 3] = 9.0
    vl = np.asarray([V, V - 3000, 0, V - 7][:B], np.int32).clip(0)
    want = pick_peaks_pallas(
        jnp.asarray(x), jnp.asarray(vl), distance, n_peaks, 2048,
        interpret=True,
    )
    for plain in (False, True):
        got = pick_peaks_dense(
            torch.from_numpy(x), torch.from_numpy(vl), distance, n_peaks,
            2048, plain=plain,
        )
        for g, w in zip(got, want):
            assert tuple(g.shape) == (B, n_peaks)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pick_peaks_dispatch_flattens_and_refuses_jnp():
    """Any leading batch shape flattens for the picker; ``"jnp"`` (once
    refused) gives the single-read picker's results; an unknown
    ``peaks_impl`` is refused."""
    x = np.random.default_rng(5).standard_normal((2, 3, 2048)).astype(
        np.float32
    )
    vl = np.full((2, 3), 2000, np.int32)
    got = pick_peaks_dispatch(
        torch.from_numpy(x), torch.from_numpy(vl), 100, 4, 512, "pallas"
    )
    want = pick_peaks_dense(
        torch.from_numpy(x.reshape(6, -1)), torch.from_numpy(vl.reshape(6)),
        100, 4, 512,
    )
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, 3, 4)
        assert torch.equal(g.reshape(6, 4), w)
    jnp_got = pick_peaks_dispatch(
        torch.from_numpy(x), torch.from_numpy(vl), 100, 4, 512, "jnp"
    )
    for g, w in zip(jnp_got, got):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="peaks_impl"):
        pick_peaks_dispatch(
            torch.from_numpy(x), torch.from_numpy(vl), 100, 4, 512, "numpy"
        )


def _core_rows(seed, B, V, block):
    """Rows with a plateau, equal peaks, and peaks on the first and the
    last column of block 1."""
    x = np.random.default_rng(seed).standard_normal((B, V)).astype(np.float32)
    x[0, 700:710] = 6.0
    x[0, 1000] = x[0, 1100] = 7.0
    x[1 % B, block] = 9.0  # the first column of block 1
    x[2 % B, 2 * block - 1] = 9.5  # the last column of block 1
    return x


@pytest.mark.parametrize(
    "V,distance,n_peaks,block",
    [
        (3 * 2048 + 5, 300, 6, 2048),  # V off the block grid
        (4096, 700, 40, 1024),  # slots exhausted
        (5000, 1, 5, 512),  # distance 1: nothing suppressed
        (2048, 10**6, 3, 1024),  # one pick empties the row
    ],
)
def test_pick_peaks_core_equals_jax(V, distance, n_peaks, block):
    """The ``"jnp"`` picker bit for bit: rows with valid_len 0, 1, 2, V
    and cut mid-row; ties, plateaus, block-edge peaks, exhausted slots."""
    x = _core_rows(V + distance, 6, V, block)
    vl = np.asarray([V, 0, 1, 2, V - 7, V // 2], np.int32)
    want = JP.pick_peaks_batch(
        jnp.asarray(x), jnp.asarray(vl), distance=distance, n_peaks=n_peaks,
        block=block,
    )
    got = TP.pick_peaks_batch(
        torch.from_numpy(x), torch.from_numpy(vl), distance, n_peaks, block
    )
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    assert np.all(np.isneginf(got[1][1:4].numpy()))  # no interior column
    if n_peaks > 10:
        assert np.isneginf(got[1][0, -1].item())  # slots ran out
    # the dispatcher's "jnp" branch is this picker
    again = pick_peaks_dispatch(
        torch.from_numpy(x), torch.from_numpy(vl), distance, n_peaks, block,
        "jnp",
    )
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_argmax_keeps_the_lowest_index():
    """The suppression rounds lean on argmax-first ties and position 0
    for an all −inf row, as ``jnp.argmax`` does."""
    y = torch.tensor([[1.0, 3.0, 3.0, 2.0], [float("-inf")] * 4])
    assert y.argmax(dim=1).tolist() == [1, 0]
    assert np.asarray(jnp.argmax(jnp.asarray(y.numpy()), axis=1)).tolist() == [
        1, 0,
    ]


@pytest.mark.parametrize(
    "distance,n_peaks",
    [(400, None), (50, 12), (1, None)],  # the last: > 256 slots, scipy
    ids=["device", "device-slots", "scipy"],
)
def test_find_peaks_device_matches_jax(distance, n_peaks):
    rng = np.random.default_rng(distance)
    x = np.convolve(rng.standard_normal(6000), np.ones(25) / 25, "same")
    x = x.astype(np.float32)
    want = JP.find_peaks_device(x, distance, 0.05, n_peaks=n_peaks)
    got = TP.find_peaks_device(
        x, distance, 0.05, n_peaks=n_peaks, device="cpu"
    )
    assert want and [p.position for p in got] == [p.position for p in want]
    for a, b in zip(got, want):
        assert abs(a.height - b.height) <= 1e-6
        assert abs(a.prominence - b.prominence) <= 1e-6
