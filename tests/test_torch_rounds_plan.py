"""The host side of the CUDA peak rounds (``ops/cuda_kernels.py``).

The kernel (``csrc/peak_rounds.cu``) runs only on a GPU, where the GPU
tests hold it to the plain rounds bit for bit. Its index arithmetic is
written out again here, as the kernel computes it, and checked on the CPU
against the plain rounds (``ops/peaks.py``): the row a CTA reads, the
tiles a pick suppresses whole, the edge tiles it rescans and the columns
of a rescan. The wrapper's layout, its refusals, and the routing between
the kernel and the plain rounds are checked without a launch.
"""

import pytest

torch = pytest.importorskip("torch")

from audio_matcher_tpu_torch import _build  # noqa: E402
from audio_matcher_tpu_torch.ops import cuda_kernels as K  # noqa: E402
from audio_matcher_tpu_torch.ops import peaks as TP  # noqa: E402

CELL_NB = 5248  # the cells' tiles a row (fft_len 2^22, 60 s chunks)
WIDE_NB = (51712, 266752)  # 2^25 (600 s chunks) and 2^28 (3100 s)

# ---- the kernel's index arithmetic (csrc/peak_rounds.cu), as it runs
SENTINEL = -(1 << 30)  # a picked slot that excludes nothing
THREADS = {True: 512, False: 1024}  # a CTA's, by layout: shared, in place


def rounds_row(L: int, packed: bool) -> tuple[int, int]:
    """(plane, row of the plane) that CTA ``L`` reads: packed, plane 0
    (``yr``) for an even logical row, 1 (``yi``) for an odd one, row
    L // 2; dense, row L of the one plane."""
    return (L & 1, L >> 1) if packed else (0, L)


def full_tiles(pos: int, d: int, block: int, nb: int) -> range:
    """The tiles a pick at ``pos`` suppresses whole: those inside
    [pos - d + 1, pos + d - 1] (the kernel's ceil and floor divisions)."""
    lo, hi = pos - d + 1, pos + d - 1
    return range(max(-(-lo // block), 0), min((hi + 1) // block, nb))


def edge_tiles(pos: int, d: int, block: int) -> tuple[int, int]:
    """The tiles of the interval's two ends, rescanned after a pick
    (either may lie off the row)."""
    return (pos - d + 1) // block, (pos + d - 1) // block


def rescan_window(tile: int, block: int, V: int) -> tuple[int, int]:
    """(first column, count) of the columns a rescan of ``tile`` tests, one
    a thread: the inner columns of the plain window of min(block + 2, V)
    columns, which starts a column before the tile, clamped into the
    row."""
    width = min(block + 2, V)
    p0 = min(max(tile * block - 1, 0), max(V - width, 0))
    return p0 + 1, width - 2


@pytest.mark.parametrize("P", [1, 4, 16])
def test_a_cta_reads_the_logical_row_of_the_packed_source(P):
    g = torch.Generator().manual_seed(P)
    yr, yi = torch.randn(P, 64, generator=g), torch.randn(P, 64, generator=g)
    scale = torch.rand(2 * P, generator=g) + 0.5
    rows = K._logical_rows(yr, yi, scale)
    src = TP._PackedPairRows(yr, yi, scale)
    cols = torch.arange(64)
    for L in range(2 * P):
        plane, r = rounds_row(L, packed=True)
        assert torch.equal((yr, yi)[plane][r] * scale[L], rows[L])
        assert torch.equal(src.columns(cols)[L], rows[L])
        assert rounds_row(L, packed=False) == (0, L)


@pytest.mark.parametrize("n_peaks", [1, 2, 64, K.MAX_PEAKS])
def test_the_layout_keeps_a_row_in_shared_memory_while_it_fits(n_peaks):
    assert K.rounds_layout(CELL_NB, n_peaks)
    for nb in WIDE_NB:
        assert not K.rounds_layout(nb, n_peaks)
    # the last row of tiles that fits, and the first that does not
    fit = (K.ROUNDS_SMEM - 12 * n_peaks) // 8
    assert K.rounds_layout(fit, n_peaks)
    assert not K.rounds_layout(fit + 1, n_peaks)


def test_a_thread_holds_a_column_of_every_tile_width():
    """The rescan and the prominences give each thread one column of a
    tile: both layouts' threads cover the widest tile."""
    assert min(THREADS.values()) >= max(K.BLOCKS)
    assert SENTINEL == TP._SENTINEL


def _plain_rounds_tiles(pos, d, block, nb):
    """The plain rounds' masks of one pick: the tiles wholly inside the
    interval, and its two edge tiles (torch's floor division)."""
    tile_start = torch.arange(nb) * block
    lo, hi = torch.tensor(pos - d + 1), torch.tensor(pos + d - 1)
    full = (tile_start >= lo) & (tile_start + block - 1 <= hi)
    edges = (torch.div(lo, block, rounding_mode="floor").item(),
             torch.div(hi, block, rounding_mode="floor").item())
    return torch.nonzero(full).flatten().tolist(), edges


@pytest.mark.parametrize("block", K.BLOCKS)
@pytest.mark.parametrize("d", [1, 2, 100, 127, 128, 129, 511, 512, 513,
                               40 * 512 + 17, 480 * 44100])
def test_full_and_edge_tiles_are_the_plain_rounds_masks(block, d):
    nb = 300
    V = nb * block
    for pos in (0, 1, block - 1, block, block + 1, 5 * block + 17,
                V // 2, V - block, V - 2, V - 1):
        full, edges = _plain_rounds_tiles(pos, d, block, nb)
        assert list(full_tiles(pos, d, block, nb)) == full, (pos, d)
        assert edge_tiles(pos, d, block) == edges, (pos, d)


def test_the_cells_distance_empties_a_row_and_rescans_nothing():
    """At the cells' shape every pick suppresses every tile, and both edge
    tiles lie off the row: the rounds after the first find nothing."""
    V = CELL_NB * 512
    for pos in (0, 1, V // 3, V - 2):
        assert list(full_tiles(pos, 480 * 44100, 512, CELL_NB)) == list(
            range(CELL_NB))
        e0, e1 = edge_tiles(pos, 480 * 44100, 512)
        assert e0 < 0 and e1 >= CELL_NB


class _Flat:
    """A row source of equal values: no column is a peak, so a rescan
    returns -inf at the first column of its window."""

    def __init__(self, rows, V):
        self.x = torch.zeros(rows, V)
        self.shape = (rows, V)

    def slices(self, starts, width):
        return TP._gather_rows(self.x, starts, width)


@pytest.mark.parametrize("block", K.BLOCKS)
@pytest.mark.parametrize("nb", [1, 2, 3, 130])
def test_the_rescan_window_is_the_plain_rescans(block, nb):
    """The columns a rescan tests, and the position of an empty one: the
    plain rescan's window, which may start before the tile and, in the
    last tile, end before the row does."""
    V = nb * block
    src = _Flat(1, V)
    valid = torch.tensor([V])
    none = torch.full((1, 2), SENTINEL)
    for tile in range(nb):
        first, count = rescan_window(tile, block, V)
        h, pos = TP._rescan_tile(src, valid, none, torch.tensor([tile]), 1,
                                 block)
        assert h.item() == float("-inf") and pos.item() == first
        cols = set(range(first, first + count))
        inside = set(range(tile * block, tile * block + block))
        # every column of the tile that can be a peak is tested
        assert inside & set(range(1, V - 1)) <= cols
        assert first >= 1 and first + count <= V - 1


def _reduced(rows, nb, block=512):
    """CPU tensors shaped as the reduction's outputs."""
    return (torch.zeros(rows, nb), torch.zeros(rows, nb, dtype=torch.int32),
            torch.zeros(rows, nb), torch.zeros(rows, nb))


@pytest.fixture
def no_launch(monkeypatch):
    """The kernel library must not be loaded."""

    def refuse():
        raise AssertionError("the wrapper reached the kernel library")

    monkeypatch.setattr(_build, "load", refuse)
    before = K.peak_rounds.launches
    yield
    assert K.peak_rounds.launches == before


def _args(P=2, nb=4, block=512, n_peaks=2):
    V = nb * block
    yr, yi = torch.zeros(P, V), torch.zeros(P, V)
    return dict(planes=(yr, yi), scale=torch.ones(2 * P),
                valid_len=torch.full((2 * P,), V), reduced=_reduced(2 * P, nb),
                distance=100, n_peaks=n_peaks, block=block)


def _bad(**changes):
    a = _args()
    a.update(changes)
    return a


@pytest.mark.parametrize(
    "args,match",
    [
        (_bad(scale=None), "scale"),
        (_bad(planes=(torch.zeros(2, 2048), torch.zeros(3, 2048))),
         "one shape"),
        (_bad(reduced=_reduced(3, 4)), "a row for each"),
        (_bad(reduced=_reduced(4, 5)), "2048 // 512"),
        (_bad(scale=torch.ones(3)), "scale must be"),
        (_bad(valid_len=torch.ones(5)), "valid_len"),
        (_bad(reduced=(torch.zeros(4, 4),) * 4), "int32"),
        (_bad(reduced=(torch.zeros(4, 4),
                       torch.zeros(4, 8, dtype=torch.int32)[:, ::2],
                       torch.zeros(4, 4), torch.zeros(4, 4))), "contiguous"),
        (_bad(n_peaks=0), "n_peaks"),
        (_bad(n_peaks=K.MAX_PEAKS + 1), "n_peaks"),
        (_bad(distance=K.MAX_DISTANCE + 1), "distance"),
        (dict(_args(nb=3, block=256), block=384, reduced=_reduced(4, 2)),
         "block"),
        (_bad(planes=(torch.zeros(2, 2048, dtype=torch.float64),) * 2),
         "float32"),
        (_args(), "CUDA"),
    ],
    ids=["scale-missing", "plane-shapes", "rows", "tiles", "scale-shape",
         "valid-shape", "dtypes", "strides", "no-slots", "too-many-slots",
         "distance", "block", "plane-dtype", "cpu"],
)
def test_the_wrapper_refuses_without_a_launch(no_launch, args, match):
    with pytest.raises(ValueError, match=match):
        K.peak_rounds(**args)


def test_dense_rows_take_no_scale(no_launch):
    x = torch.zeros(3, 1024)
    with pytest.raises(ValueError, match="without"):
        K.peak_rounds((x,), torch.ones(3), torch.ones(3), _reduced(3, 2),
                      10, 2, 512)
    with pytest.raises(ValueError, match="CUDA"):
        K.peak_rounds((x,), None, torch.ones(3), _reduced(3, 2), 10, 2, 512)


class _RoutedSource:
    """A source whose reduction reports the device it ran on, to follow
    the route ``_pick_peaks_from_source`` takes."""

    class _Out:
        def __init__(self, is_cuda):
            self.is_cuda = is_cuda

    def __init__(self, is_cuda, plain):
        self.is_cuda, self.plain, self.calls = is_cuda, plain, []

    def block_reduce(self, valid_len, block):
        return (self._Out(self.is_cuda), None, None, None)

    def peak_rounds(self, *args):
        self.calls.append("kernel")
        return "kernel"


@pytest.mark.parametrize("is_cuda,plain,route", [
    (True, False, "kernel"), (True, True, "plain"), (False, False, "plain"),
    (False, True, "plain"),
])
def test_only_cuda_rows_off_plain_take_the_kernel(monkeypatch, is_cuda, plain,
                                                  route):
    """The kernel for a CUDA reduction with ``plain`` False, the plain
    rounds otherwise; nothing falls back from one to the other."""
    src = _RoutedSource(is_cuda, plain)
    monkeypatch.setattr(TP, "_peak_rounds_plain", lambda *a: "plain")
    assert TP._pick_peaks_from_source(src, None, 10, 2, 512) == route
    assert src.calls == (["kernel"] if route == "kernel" else [])
