"""The port's CUDA kernels against their plain versions, on a GPU.

Marked ``gpu``: these need a CUDA device and nvcc, and skip without them
(a CUDA kernel has no CPU mode). Run them on a GPU machine with

    python -m pytest tests/test_torch_gpu.py -m gpu

FFT passes agree with their plain versions (cuFFT) within 1e-5 of the
largest plain value (measured about 3e-7), at every fft_len 2^14 to 2^28
(factors 128 to 16384); the block reduction and the
peak picks are exact. Every ``fft_impl`` × ``peaks_impl`` runs on the card
against ``plain=True``.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import audio_matcher_tpu_torch as port  # noqa: E402
from audio_matcher_tpu_torch.models.matcher import (  # noqa: E402
    FFT_IMPLS,
    PEAKS_IMPLS,
    MatchConfig,
    SnippetMatcher,
    quantize_wire,
    scan_slab,
)
from audio_matcher_tpu_torch.ops import cuda_fft as F  # noqa: E402
from audio_matcher_tpu_torch.ops import cuda_kernels as K  # noqa: E402
from audio_matcher_tpu_torch.parallel.sweep import ShardedScanner  # noqa: E402

pytestmark = pytest.mark.gpu
TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert ((g - w).abs().max() / w.abs().max()).item() < TOL


# every factor 128 .. 4096: A = M at even log2 n, M = 2A at odd
SIZES = [1 << e for e in range(14, 25)]
# factors 8192 and 16384: the minor pass's rows on clusters of 2 and 4
# blocks (its product mode's one-row blocks), the major pass's clusters of 4
# and 8 blocks, the cross twiddle's split exponent
WIDE_SIZES = [1 << e for e in range(25, 29)]


@pytest.mark.parametrize("n", SIZES + WIDE_SIZES)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.float32])
def test_fft_passes_match_plain(dev, n, dtype):
    g = torch.Generator(device=dev).manual_seed(n)
    A, M = F.split_factors(n)
    W, chunk = int(n * 0.77), int(n * 0.6)
    # fewer planes as n grows: the plain versions' complex temporaries
    B = 3 if n <= 1 << 24 else 2 if n <= 1 << 26 else 1
    Qh = 4 if n <= 1 << 22 else 2 if n <= 1 << 24 else 1
    if dtype == torch.uint8:
        ep = torch.randint(0, 256, ((B - 1) * chunk + W,), device=dev,
                           generator=g, dtype=torch.int32).to(dtype)
    else:
        ep = (torch.randn((B - 1) * chunk + W, device=dev, generator=g)
              * 3000).to(dtype)
    win = ep.as_strided((B, W), (chunk, 1))
    X = F.fft_major_fwd_wire(win, A, n, W)
    _close(X, F.fft_major_fwd_wire_plain(win, A, n, W))
    Y = F.fft_minor(X[0], X[1], M)
    _close(Y, F.fft_minor_plain(X[0], X[1], M))
    tr = torch.randn(Qh, A, M, device=dev, generator=g)
    ti = torch.randn(Qh, A, M, device=dev, generator=g)
    V = F.ifft_minor_product(Y[0], Y[1], tr, ti, M)
    _close(V, F.ifft_minor_product_plain(Y[0], Y[1], tr, ti, M))
    a_crop = A // 2 + 8
    Z = F.fft_major(V[0], V[1], A, n, a_crop)
    _close(Z, F.fft_major_plain(V[0], V[1], A, n, a_crop))


def test_passes_refuse_factors_past_the_tile(dev):
    n = 1 << 29  # M = 32768: a line of 2048 threads of 16 points
    A, M = F.split_factors(n)
    x = torch.zeros(1, device=dev).expand(1, A, M)  # shapes only: no bytes
    wire = torch.zeros(1, dtype=torch.uint8, device=dev).expand(1, n)
    for call in (lambda: F.fft_minor(x, x, M),
                 lambda: F.ifft_minor(x, x, M),
                 lambda: F.fft_major_forward(x, x, A, n),
                 lambda: F.fft_major_fwd_wire(wire, A, n, n)):
        with pytest.raises(ValueError, match="16384"):
            call()
    snippet = np.zeros(80000, np.float32)
    snippet[::7] = 0.1
    with pytest.raises(ValueError, match="2\\^28"):
        SnippetMatcher(snippet, 8000, MatchConfig(chunk_secs=34000.0),
                       device=dev)


@pytest.mark.parametrize("n", SIZES + WIDE_SIZES)
def test_new_modes_match_plain(dev, n):
    """The inverse minor pass and the forward major pass of complex
    planes, and the fft2_scrambled round trip (n·x)."""
    g = torch.Generator(device=dev).manual_seed(n + 1)
    A, M = F.split_factors(n)
    P = 4 if n <= 1 << 22 else 2 if n <= 1 << 26 else 1
    xr = torch.randn(P, A, M, device=dev, generator=g)
    xi = torch.randn(P, A, M, device=dev, generator=g)
    _close(F.fft_major_forward(xr, xi, A, n),
           F.fft_major_forward_plain(xr, xi, A, n))
    _close(F.ifft_minor(xr, xi, M), F.ifft_minor_plain(xr, xi, M))
    X = F.fft2_scrambled(xr.view(P, n), xi.view(P, n), n)
    _close(X, F.fft2_scrambled(xr.view(P, n), xi.view(P, n), n, plain=True))
    back = F.fft2_scrambled(X[0], X[1], n, inverse=True)
    _close(back, (xr.view(P, n) * n, xi.view(P, n) * n))


@pytest.mark.parametrize("n", SIZES + WIDE_SIZES)
@pytest.mark.parametrize("P", [1, 3])
def test_passes_at_one_and_odd_planes_every_crop_and_twice(dev, n, P):
    """Every mode at P = 1 and an odd P, the inverse major pass at a_crop
    1, A/2 + 8 and A; a second launch of each is bitwise equal to the
    first (no order-dependent arithmetic: the cluster passes' exchange
    too). One query pair for the product above 2^24 (memory)."""
    g = torch.Generator(device=dev).manual_seed(n + P)
    A, M = F.split_factors(n)
    Qh = 2 if n <= 1 << 24 else 1
    xr = torch.randn(P, A, M, device=dev, generator=g)
    xi = torch.randn(P, A, M, device=dev, generator=g)
    tr = torch.randn(Qh, A, M, device=dev, generator=g)
    ti = torch.randn(Qh, A, M, device=dev, generator=g)
    ep = _wire_episode(dev, g, torch.uint8, P * n)
    w0, w1 = ep.view(P, n), ep.view(P, n)[: P // 2]
    cases = {
        "fft_minor": (lambda: F.fft_minor(xr, xi, M),
                      lambda: F.fft_minor_plain(xr, xi, M)),
        "ifft_minor": (lambda: F.ifft_minor(xr, xi, M),
                       lambda: F.ifft_minor_plain(xr, xi, M)),
        "ifft_minor_product": (
            lambda: F.ifft_minor_product(xr, xi, tr, ti, M),
            lambda: F.ifft_minor_product_plain(xr, xi, tr, ti, M)),
        "fft_major_forward": (
            lambda: F.fft_major_forward(xr, xi, A, n),
            lambda: F.fft_major_forward_plain(xr, xi, A, n)),
        "fft_major_fwd_wire": (
            lambda: F.fft_major_fwd_wire(w0, A, n, n - 5),
            lambda: F.fft_major_fwd_wire_plain(w0, A, n, n - 5)),
        "fft_major_fwd_wire2": (
            lambda: F.fft_major_fwd_wire2(w0, w1, A, n, n - 5),
            lambda: F.fft_major_fwd_wire2_plain(w0, w1, A, n, n - 5)),
    }
    for a_crop in (1, A // 2 + 8, A):
        cases[f"fft_major a_crop {a_crop}"] = (
            lambda c=a_crop: F.fft_major(xr, xi, A, n, c),
            lambda c=a_crop: F.fft_major_plain(xr, xi, A, n, c))
    for name, (kernel, plain) in cases.items():
        got, again = kernel(), kernel()
        assert all(torch.equal(a, b) for a, b in zip(got, again)), name
        del again
        _close(got, plain())
        del got
        torch.cuda.empty_cache()


def test_cluster_passes_fit_the_card_and_a_refused_launch_raises(
        dev, monkeypatch):
    """Every cluster pass (A = 8192 and 16384) gets clusters on the card
    (``cudaOccupancyMaxActiveClusters`` at its shared memory). Where the
    card holds none, the entry point returns cudaErrorLaunchOutOfResources
    (701) without launching: the wrapper raises, counts no launch and
    falls back to nothing."""
    for A in (8192, 16384):
        for kernel in (F.fft_major_fwd_wire, F.fft_major_fwd_wire2,
                       F.fft_major_forward, F.fft_major):
            for dtype in (torch.uint8, torch.int16, torch.float32):
                assert F.major_clusters(kernel, A, dtype, dev) > 0
    with pytest.raises(ValueError, match="clusters"):
        F.major_clusters(F.fft_major, 4096, device=dev)
    lib = F._build.load()

    class Refused:  # the library, its cluster launches refused
        def __getattr__(self, name):
            if name.startswith("am_major_"):
                return lambda *args: 701
            return getattr(lib, name)

    monkeypatch.setattr(F._build, "load", lambda: Refused())
    n = 1 << 26
    A, M = F.split_factors(n)
    x = torch.zeros((1, A, M), device=dev)
    wire = torch.zeros((1, n), dtype=torch.uint8, device=dev)
    for kernel, call in (
            (F.fft_major, lambda: F.fft_major(x, x, A, n, A)),
            (F.fft_major_forward, lambda: F.fft_major_forward(x, x, A, n)),
            (F.fft_major_fwd_wire, lambda: F.fft_major_fwd_wire(wire, A, n,
                                                                n)),
            (F.fft_major_fwd_wire2, lambda: F.fft_major_fwd_wire2(
                wire, wire, A, n, n))):
        before = kernel.launches
        with pytest.raises(RuntimeError, match="CUDA error 701"):
            call()
        assert kernel.launches == before


@pytest.mark.parametrize("M", [8192, 16384])
def test_minor_rows_on_clusters_match_plain_at_every_row_count(dev, M):
    """The forward and inverse minor modes at M = 8192 and 16384 (a row on
    a cluster of M/4096 blocks) on 1 row, an odd number of rows and more
    rows than twice the clusters the card holds at once, none a multiple
    of them, against plain; a second launch bitwise equal."""
    g = torch.Generator(device=dev).manual_seed(M)
    clusters = {k: F.minor_clusters(k, M, dev)
                for k in (F.fft_minor, F.ifft_minor)}
    assert min(clusters.values()) > 0
    most = 2 * max(clusters.values()) + 1
    for rows in (1, 3, most):
        xr = torch.randn(rows, M, device=dev, generator=g)
        xi = torch.randn(rows, M, device=dev, generator=g)
        for kernel, plain in ((F.fft_minor, F.fft_minor_plain),
                              (F.ifft_minor, F.ifft_minor_plain)):
            before = kernel.launches
            got, again = kernel(xr, xi, M), kernel(xr, xi, M)
            assert kernel.launches == before + 2
            assert all(torch.equal(a, b) for a, b in zip(got, again))
            _close(got, plain(xr, xi, M))


def test_minor_clusters_fit_the_card_and_a_refused_launch_raises(
        dev, monkeypatch):
    """The minor pass's rows on clusters get clusters on the card at M =
    8192 and 16384, none below (blocks, not clusters). Where the card
    holds none the entry point returns cudaErrorLaunchOutOfResources
    (701) without launching: the wrapper raises, counts no launch and
    falls back to nothing."""
    for M in (8192, 16384):
        for kernel in (F.fft_minor, F.ifft_minor):
            assert F.minor_clusters(kernel, M, dev) > 0
    with pytest.raises(ValueError, match="clusters"):
        F.minor_clusters(F.fft_minor, 4096, dev)
    with pytest.raises(ValueError, match="clusters"):
        F.minor_clusters(F.ifft_minor_product, 8192, dev)
    lib = F._build.load()

    class Refused:  # the library, its minor launches refused
        def __getattr__(self, name):
            if name in ("am_minor_forward", "am_minor_inverse"):
                return lambda *args: 701
            return getattr(lib, name)

    monkeypatch.setattr(F._build, "load", lambda: Refused())
    x = torch.zeros((2, 8192), device=dev)
    for kernel in (F.fft_minor, F.ifft_minor):
        before = kernel.launches
        with pytest.raises(RuntimeError, match="CUDA error 701"):
            kernel(x, x, 8192)
        assert kernel.launches == before


@pytest.mark.parametrize("L", [1 << e for e in range(7, 13)])
def test_twiddle_table_within_an_ulp_of_float64(dev, L):
    got = F.twiddle_table(L, dev).cpu().numpy().astype(np.float64)
    k = np.arange(L)
    m = 1 << np.maximum(np.floor(np.log2(np.maximum(k, 1))), 0).astype(int)
    want = np.exp(-1j * np.pi * (k - m) / m)
    want[0] = 1.0
    for g, w in ((got[:, 0], want.real), (got[:, 1], want.imag)):
        ulp = np.spacing(np.abs(w).astype(np.float32)).astype(np.float64)
        assert (np.abs(g - w) <= ulp + 1e-15).all()


def test_passes_refuse_misaligned_planes(dev):
    M = 128
    buf = torch.zeros(M * M + 1, device=dev)
    x = buf[1:].view(1, M, M)  # contiguous, 4 bytes off alignment
    w = torch.zeros((1, M * M), dtype=torch.uint8, device=dev)
    for call in (lambda: F.fft_minor(x, x, M), lambda: F.ifft_minor(x, x, M),
                 lambda: F.fft_major(x, x, M, M * M, M),
                 lambda: F.fft_major_forward(x, x, M, M * M),
                 lambda: F.fft_major_fwd_wire(w, M, M * M, M * M, (x, x)),
                 lambda: F.fft_major_fwd_wire2(w, w, M, M * M, M * M,
                                               (x, x))):
        with pytest.raises(ValueError, match="16-byte"):
            call()


def test_argmax_keeps_the_lowest_index_on_cuda(dev):
    """The ``"jnp"`` picker's suppression rounds need argmax-first ties
    and position 0 for an all −inf row, as ``jnp.argmax`` gives them."""
    y = torch.full((3, 1 << 20), float("-inf"), device=dev)
    y[1, 7:] = 2.0
    y[2, 1000] = y[2, 900000] = 5.0
    assert y.argmax(dim=1).tolist() == [0, 7, 1000]


def test_entry_points_default_to_cuda(dev):
    sr = 8000
    rng = np.random.default_rng(10)
    snippet = (rng.standard_normal(4000) * 0.2).astype(np.float32)
    ep = (rng.standard_normal(9 * sr) * 0.05).astype(np.float32)
    ep[2 * sr : 2 * sr + 4000] = snippet
    before = K.local_max_block_reduce_packed.launches
    peaks = port.match(snippet, ep, sr, chunk_secs=1.0, distance_secs=2.0)
    assert [p.position for p in peaks] == [2 * sr]
    assert K.local_max_block_reduce_packed.launches > before
    assert ShardedScanner([snippet], sr).device.type == "cuda"


@pytest.mark.parametrize("fft_impl", FFT_IMPLS)
@pytest.mark.parametrize("peaks_impl", PEAKS_IMPLS)
def test_every_impl_kernel_path_matches_plain_path(dev, fft_impl,
                                                   peaks_impl):
    """Each ``fft_impl`` × ``peaks_impl`` through ``SnippetMatcher`` and
    through ``ShardedScanner`` at Q = 3, on the card against
    ``plain=True``."""
    sr = 8000
    rng = np.random.default_rng(11)
    snippets = [(rng.standard_normal(m) * 0.2).astype(np.float32)
                for m in (4000, 3600, 3800)]
    ep = (rng.standard_normal(23 * sr) * 0.05).astype(np.float32)
    for q, at in ((0, 3.0), (2, 14.5)):
        ep[int(at * sr) : int(at * sr) + len(snippets[q])] = snippets[q]
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0, slab=5,
                      slab_auto=False, transfer_dtype="mulaw8",
                      fft_impl=fft_impl, peaks_impl=peaks_impl)
    m = SnippetMatcher(snippets[0], sr, cfg, device=dev)
    p = SnippetMatcher(snippets[0], sr, cfg, device=dev, plain=True)
    got, want = m.match(ep), p.match(ep)
    assert [q.position for q in got] == [q.position for q in want] == [3 * sr]
    assert abs(got[0].height - want[0].height) <= 1.2e-5
    scanner = ShardedScanner(snippets, sr, cfg, device=dev)
    plain = ShardedScanner(snippets, sr, cfg, device=dev,
                           query_state=scanner.query_state, plain=True)
    staged = scanner.stage_resident([quantize_wire(ep, "mulaw8")])
    got = scanner.scan_dispatch(staged)
    _assert_paths_agree(got[0], plain.scan_dispatch(staged)[0])
    peaks = scanner.scan_collect(got)[0]
    assert [q.position for q in peaks[0]] == [3 * sr]
    assert [q.position for q in peaks[2]] == [int(14.5 * sr)]


@pytest.mark.parametrize("block", K.BLOCKS)
def test_block_reduce_matches_plain(dev, block):
    g = torch.Generator(device=dev).manual_seed(block)
    P, V = 3, block * 300
    yr = torch.randn(P, V, device=dev, generator=g)
    yi = torch.randn(P, V, device=dev, generator=g)
    yr[0, 1000:1010] = 6.0
    yr[0, block * 128 - 1] = 9.0
    yr[0, block * 128] = 9.5
    yi[1, ::7] = 2.0
    scale = torch.rand(2 * P, device=dev, generator=g) + 0.5
    vl = torch.tensor([V, 0, V - 7, block * 128 + 1, 5, V],
                      dtype=torch.int32, device=dev)
    got = K.local_max_block_reduce_packed(yr, yi, scale, vl, block)
    want = K.local_max_block_reduce_packed_plain(yr, yi, scale, vl, block)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_block_reduce_refuses_misaligned_planes(dev):
    P, V = 2, 512 * 4
    buf = torch.randn(P * V + 4, device=dev)
    yr = buf[1 : 1 + P * V].view(P, V)  # contiguous, 4 bytes off alignment
    scale = torch.ones(2 * P, device=dev)
    vl = torch.full((2 * P,), V, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        K.local_max_block_reduce_packed(yr, yr, scale, vl, 512)
    ok = buf[4 : 4 + P * V].view(P, V)  # 16 bytes off: accepted
    got = K.local_max_block_reduce_packed(ok, ok, scale, vl, 512)
    want = K.local_max_block_reduce_packed_plain(ok, ok, scale, vl, 512)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_scan_kernel_path_matches_plain_path(dev):
    sr = 8000
    rng = np.random.default_rng(4)
    snippets = [(rng.standard_normal(m) * 0.2).astype(np.float32)
                for m in (4000, 3600, 3800)]
    ep = (rng.standard_normal(40 * sr) * 0.05).astype(np.float32)
    for q, at in ((0, 3.0), (2, 21.5)):
        ep[int(at * sr) : int(at * sr) + len(snippets[q])] = snippets[q]
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0,
                      transfer_dtype="mulaw8")
    scanner = ShardedScanner(snippets, sr, cfg, device=dev)
    plain = ShardedScanner(snippets, sr, cfg, device=dev,
                           query_state=scanner.query_state, plain=True)
    staged = scanner.stage_resident([quantize_wire(ep, "mulaw8")] * 2)
    path = (F.fft_major_fwd_wire, F.fft_minor, F.ifft_minor_product,
            F.fft_major, K.local_max_block_reduce_packed)
    before = [k.launches for k in path]
    got = scanner.scan_dispatch(staged)
    after = [k.launches for k in path]
    assert all(a > b for a, b in zip(after, before))
    want = plain.scan_dispatch(staged)
    assert [k.launches for k in path] == after
    for a, b in zip(got[0], want[0]):
        fin = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), fin)
    assert torch.equal(got[0][0], want[0][0])
    for a, b in zip(got[0][1:], want[0][1:]):
        fin = torch.isfinite(b)
        assert (a[fin] - b[fin]).abs().max().item() <= 1.2e-5
    peaks = scanner.scan_collect(got)
    assert [p.position for p in peaks[0][0]] == [3 * sr]
    assert [p.position for p in peaks[1][2]] == [int(21.5 * sr)]


@pytest.mark.parametrize("n_queries", [3, 1])
@pytest.mark.parametrize("cards", [1, 2])
def test_sharded_scan_equals_one_device_scan(dev, cards, n_queries):
    """Three episodes over one card twice (2 rows, then 1), or over two
    cards taken twice in turn (a row each on cuda:0, cuda:1, cuda:0: each
    card's shards issued by its own thread, read back in row order):
    exactly the one-device scan, with the same launches of the path's
    kernels, and the plain twin's peaks within 1.2e-5."""
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA devices")
    from audio_matcher_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh.of([dev, dev] if cards == 1
                   else ["cuda:0", "cuda:1", "cuda:0", "cuda:1"])
    sr = 8000
    rng = np.random.default_rng(17)
    snippets = [(rng.standard_normal(m) * 0.2).astype(np.float32)
                for m in (4000, 3600, 3800)][:n_queries]
    episodes = []
    for e, secs in enumerate((12.0, 7.5, 10.0)):
        ep = (rng.standard_normal(int(secs * sr)) * 0.05).astype(np.float32)
        q = e % n_queries
        ep[int(2.5 * sr) : int(2.5 * sr) + len(snippets[q])] = snippets[q]
        episodes.append(quantize_wire(ep, "mulaw8"))
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0,
                      transfer_dtype="mulaw8")
    first = F.fft_major_fwd_wire if n_queries > 1 else F.fft_major_fwd_wire2
    path = (first, F.fft_minor, F.ifft_minor_product, F.fft_major,
            K.local_max_block_reduce_packed)
    counts = []
    runs = []
    for device in (dev, mesh):
        before = [k.launches for k in path]
        runs.append(ShardedScanner(snippets, sr, cfg, device=device)
                    .scan_resident(episodes))
        counts.append([k.launches - b for k, b in zip(path, before)])
    assert counts[0] == counts[1] and all(counts[0]), counts
    assert runs[1] == runs[0]
    plain = ShardedScanner(snippets, sr, cfg, device=mesh, plain=True)
    want = plain.scan_resident(episodes)
    for got_e, want_e in zip(runs[1], want):
        for got_q, want_q in zip(got_e, want_e):
            assert [p.position for p in got_q] == [p.position for p in want_q]
            for a, b in zip(got_q, want_q):
                assert abs(a.height - b.height) <= 1.2e-5
                assert abs(a.prominence - b.prominence) <= 1.2e-5
    for e in range(3):
        assert int(2.5 * sr) in [p.position for p in runs[1][e][e % n_queries]]


def test_sharded_sweep_and_dryrun_on_one_card_twice(dev, tmp_path):
    """``sweep_archive`` on a mesh of one card twice gives the one-device
    sweep's peaks exactly; the dry run passes on that mesh."""
    from audio_matcher_tpu_torch.hostio.decode import write_wav
    from audio_matcher_tpu_torch.parallel.dryrun import dryrun_multichip
    from audio_matcher_tpu_torch.parallel.mesh import Mesh
    from audio_matcher_tpu_torch.parallel.sweep import sweep_archive

    sr = 8000
    rng = np.random.default_rng(19)
    snippets = [(rng.standard_normal(4000) * 0.2).astype(np.float32)]
    paths = []
    for e in range(5):
        ep = (rng.standard_normal((6 + e) * sr) * 0.05).astype(np.float32)
        ep[(1 + e) * sr : (1 + e) * sr + 4000] = snippets[0]
        paths.append(tmp_path / f"ep{e}.wav")
        write_wav(paths[-1], sr, ep)
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0,
                      transfer_dtype="int16")
    mesh = Mesh.of([dev, dev])
    one, two = (sweep_archive(paths, snippets, sr, cfg, device=d,
                              group_size=2) for d in (dev, mesh))
    assert two == one and len(one) == 5
    for e, p in enumerate(paths):
        assert [pk.position for pk in one[str(p)][0]] == [(1 + e) * sr]
    assert dryrun_multichip(mesh).startswith("dryrun_multichip OK")


def _wire_episode(dev, g, dtype, length):
    if dtype == torch.uint8:
        return torch.randint(0, 256, (length,), device=dev, generator=g,
                             dtype=torch.int32).to(dtype)
    return (torch.randn(length, device=dev, generator=g) * 3000).to(dtype)


@pytest.mark.parametrize("n", [1 << 14, 1 << 21, 1 << 22, 1 << 23, 1 << 24]
                         + WIDE_SIZES)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.float32])
@pytest.mark.parametrize("B", [4, 5])
def test_major_fwd_wire2_matches_plain(dev, n, dtype, B):
    """Kernel 6 on strided even/odd windows of one episode; odd B pairs
    the last window with wire silence (at 2^27 and 2^28 B = 2 and 1, P =
    1: one pair, and one window with silence)."""
    if n > 1 << 26:
        B -= 3
    g = torch.Generator(device=dev).manual_seed(n + B)
    A, M = F.split_factors(n)
    W, chunk = int(n * 0.77), int(n * 0.6)
    ep = _wire_episode(dev, g, dtype, (B - 1) * chunk + W)
    win = ep.as_strided((B, W), (chunk, 1))
    got = F.fft_major_fwd_wire2(win[0::2], win[1::2], A, n, W)
    assert got[0].shape == ((B + 1) // 2, A, M)
    _close(got, F.fft_major_fwd_wire2_plain(win[0::2], win[1::2], A, n, W))


def test_major_fwd_wire2_refuses_bad_pairs(dev):
    n = 1 << 14
    A, _ = F.split_factors(n)
    x = torch.zeros((3, n), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):  # more odd than even windows
        F.fft_major_fwd_wire2(x[:2], x, A, n, n)
    with pytest.raises(ValueError):  # mixed wire dtypes
        F.fft_major_fwd_wire2(x, x.to(torch.int16), A, n, n)


@pytest.mark.parametrize("block", K.BLOCKS)
def test_dense_block_reduce_matches_plain(dev, block):
    """Kernel 7 with seams (V > GROUP·block), valid lengths cut mid-tile
    and at a seam."""
    g = torch.Generator(device=dev).manual_seed(block + 1)
    B, V = 6, block * 300
    x = torch.randn(B, V, device=dev, generator=g)
    x[0, 1000:1010] = 6.0
    x[0, block * 128 - 1] = 9.0
    x[0, block * 128] = 9.5
    x[1, ::7] = 2.0
    vl = torch.tensor([V, 0, V - 7, block * 128 + 1, 5, V],
                      dtype=torch.int32, device=dev)
    got = K.local_max_block_reduce(x, vl, block)
    want = K.local_max_block_reduce_plain(x, vl, block)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_dense_block_reduce_refuses_misaligned_rows(dev):
    B, V = 2, 512 * 4
    buf = torch.randn(B * V + 4, device=dev)
    vl = torch.full((B,), V, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        K.local_max_block_reduce(buf[1 : 1 + B * V].view(B, V), vl, 512)
    ok = buf[4 : 4 + B * V].view(B, V)
    for a, b in zip(K.local_max_block_reduce(ok, vl, 512),
                    K.local_max_block_reduce_plain(ok, vl, 512)):
        assert torch.equal(a, b)


def _assert_paths_agree(got, want):
    for a, b in zip(got, want):
        assert torch.equal(torch.isfinite(a), torch.isfinite(b))
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        fin = torch.isfinite(b)
        assert (a[fin] - b[fin]).abs().max().item() <= 1.2e-5


@pytest.mark.parametrize("slab", [8, 5])
def test_single_query_scan_kernel_path_matches_plain_path(dev, slab):
    """Q = 1 through the scanner: kernel 6, the Qh = 1 product and the
    P-plane inverse major on the card, against the plain path."""
    sr = 8000
    rng = np.random.default_rng(6)
    snippet = (rng.standard_normal(4000) * 0.2).astype(np.float32)
    ep = (rng.standard_normal(27 * sr) * 0.05).astype(np.float32)
    ep[3 * sr : 3 * sr + 4000] = snippet
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0, slab=slab,
                      slab_auto=False, transfer_dtype="mulaw8")
    scanner = ShardedScanner([snippet], sr, cfg, device=dev)
    plain = ShardedScanner([snippet], sr, cfg, device=dev,
                           query_state=scanner.query_state, plain=True)
    staged = scanner.stage_resident([quantize_wire(ep, "mulaw8")])
    before = F.fft_major_fwd_wire2.launches
    got = scanner.scan_dispatch(staged)
    assert F.fft_major_fwd_wire2.launches > before
    _assert_paths_agree(got[0], plain.scan_dispatch(staged)[0])
    assert [p.position for p in scanner.scan_collect(got)[0][0]] == [3 * sr]


def test_snippet_matcher_kernel_path_matches_plain_path(dev):
    sr = 8000
    rng = np.random.default_rng(8)
    snippet = (rng.standard_normal(4000) * 0.2).astype(np.float32)
    ep = (rng.standard_normal(21 * sr) * 0.05).astype(np.float32)
    ep[5 * sr : 5 * sr + 4000] = snippet
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0,
                      transfer_dtype="int16")
    m = SnippetMatcher(snippet, sr, cfg, device=dev)
    p = SnippetMatcher(snippet, sr, cfg, device=dev, plain=True)
    got, want = m.match(ep), p.match(ep)
    assert [q.position for q in got] == [q.position for q in want] == [5 * sr]
    assert abs(got[0].height - want[0].height) <= 1.2e-5


def test_config2_live_path_matches_the_reference_at_published_widths(dev):
    """BASELINE config #2 as the matcher CLI runs it: one 3600 s float32
    episode at 44.1 kHz against one 10 s snippet, chunk 60 s (fft_len
    2^22), distance 480 s, through ``match`` with a progress callback (the
    live path: 8 slabs in 2 groups, kernel 6 on the float32 wire). The
    positions are the plain reference's (``portbench/reference/
    xcorr_peaks.py``, ``torch.fft`` on the card), heights and
    prominences within 1e-4 of it (``snippet_1h``'s limits)."""
    from portbench.reference import xcorr_peaks as ref

    sr, secs, m = 44100, 3600, 10 * 44100
    g = torch.Generator(device=dev).manual_seed(2024)
    snippet = (torch.randn(m, generator=g, device=dev) * 0.15).clamp(
        -0.45, 0.45)
    episode = torch.randn(secs * sr, generator=g, device=dev) * 0.03
    planted = [int((40 + 550 * k) * sr) + 1234 * k for k in range(6)]
    for k, at in enumerate(planted):
        episode[at : at + m] += (0.4 + 0.1 * k) * snippet
    snip, ep = snippet.cpu().numpy(), episode.cpu().numpy()
    del episode
    cfg = MatchConfig(chunk_secs=60.0, distance_secs=480.0, prominence=13.0,
                      transfer_dtype="float32")
    matcher = SnippetMatcher(snip, sr, cfg, device=dev)
    phases = []
    before = F.fft_major_fwd_wire2.launches
    got = matcher.match(ep, scale=True, n_samples=len(ep),
                        progress=lambda phase, k: phases.append(phase))
    assert F.fft_major_fwd_wire2.launches > before
    assert phases.count("start") == phases.count("finish") == 60
    assert matcher.step_graphs.stats["first"] == 1  # one key: both groups
    assert matcher.step_graphs.stats["captures"] == 1
    geo = ref.geometry({"sample_rate": sr, "match": {
        "chunk_secs": 60.0, "distance_secs": 480.0, "prominence": 13.0,
        "max_peaks_per_chunk": 64}}, [m])
    want = ref.peaks_of(ref.dequantize(ep, "float32", dev), snip, geo)
    assert [w[0] for w in want] == planted
    assert [p.position for p in got] == planted
    for p, w in zip(got, want):
        assert abs(p.height - w[1]) <= 1e-4
        assert abs(p.prominence - w[2]) <= 1e-4


def test_xla_packed_scan_launches_the_dense_reduction(dev):
    """fft_impl="xla_packed": torch.fft correlation, kernel 7 peaks."""
    sr = 8000
    rng = np.random.default_rng(9)
    snippets = [(rng.standard_normal(m) * 0.2).astype(np.float32)
                for m in (4000, 3600, 3800)]
    ep = (rng.standard_normal(12 * sr) * 0.05).astype(np.float32)
    ep[4 * sr : 4 * sr + 4000] = snippets[0]
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0,
                      fft_impl="xla_packed", transfer_dtype="mulaw8")
    scanner = ShardedScanner(snippets, sr, cfg, device=dev)
    plain = ShardedScanner(snippets, sr, cfg, device=dev,
                           query_state=scanner.query_state, plain=True)
    staged = scanner.stage_resident([quantize_wire(ep, "mulaw8")])
    before = K.local_max_block_reduce.launches
    got = scanner.scan_dispatch(staged)
    assert K.local_max_block_reduce.launches > before
    _assert_paths_agree(got[0], plain.scan_dispatch(staged)[0])
    assert [p.position for p in scanner.scan_collect(got)[0][0]] == [4 * sr]


def _reduce_case(dev, g, rows, V, block):
    """[rows, V] values with plateaus, two equal maxima in one tile (the
    lower column must win), seam peaks and negative stretches, and
    valid_len cycling through its edge values."""
    seg = K.GROUP * block
    x = torch.randn(rows, V, device=dev, generator=g)
    x[:, 3 : 3 + min(10, V - 3)] = 6.0  # a plateau: never a peak
    if V >= block:
        x[:, 10] = x[:, block - 40] = 9.0  # equal maxima in tile 0
        x[:, V // 2 : V // 2 + 5] -= 20.0
    if V > seg:
        x[:, seg - 1] = 12.0
        x[:, seg] = 12.5
    edges = [0, 1, 2, block - 1, block + 1, seg - 1, seg + 1, V, V + 1]
    vl = torch.tensor([edges[r % len(edges)] for r in range(rows)],
                      dtype=torch.int32, device=dev)
    return x, vl


def _reduce_both_modes(x, vl, block):
    """Both reductions against their plain versions, exactly: dense over
    the rows, packed over the rows as (even, odd) planes with a scale."""
    got = K.local_max_block_reduce(x, vl, block)
    want = K.local_max_block_reduce_plain(x, vl, block)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    R = x.shape[0] - x.shape[0] % 2
    if R:
        scale = torch.linspace(0.5, 1.5, R, device=x.device)
        yr, yi = x[0:R:2].contiguous(), x[1:R:2].contiguous()
        got = K.local_max_block_reduce_packed(yr, yi, scale, vl[:R], block)
        want = K.local_max_block_reduce_packed_plain(yr, yi, scale, vl[:R],
                                                     block)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("block", K.BLOCKS)
@pytest.mark.parametrize("rows,nb", [(1, 1), (3, 1), (1, 300), (7, 3 * 128),
                                     (512, 999), (512, 130)])
def test_block_reduce_edge_cases_match_plain(dev, block, rows, nb):
    """Both modes exactly equal to plain at one-tile rows, odd rows, rows
    of up to three segments, and a run length that does not divide the
    tiles of a row (512 x 999)."""
    g = torch.Generator(device=dev).manual_seed(block * rows + nb)
    x, vl = _reduce_case(dev, g, rows, nb * block, block)
    if (rows, nb) == (512, 999):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        run = K.reduce_grid(rows, nb, sms)[0]
        assert run > 1 and nb % run
    _reduce_both_modes(x, vl, block)


@pytest.mark.parametrize("block", K.BLOCKS)
@pytest.mark.parametrize("rows", [65535, 65537, 65538])
def test_block_reduce_near_max_rows(dev, block, rows):
    """Around the 65535 rows one grid axis held: the 1-D warp grid takes
    65537 dense rows and 65538 packed ones (32769 planes), exactly."""
    g = torch.Generator(device=dev).manual_seed(block + rows)
    x, vl = _reduce_case(dev, g, rows, block, block)
    _reduce_both_modes(x, vl, block)


# ------------------------------------------------------------ peak rounds
CELL_NB = 5248  # the cells' tiles a row: fft_len 2^22, 60 s chunks, block 512
CELL_DISTANCE = 480 * 44100  # the cells' distance: every pick empties a row


def _rounds_planes(dev, seed, P, nb, block):
    """Pair-packed planes [P, nb·block] with a scale and the picker's
    traps planted in row 0's planes: a plateau, equal heights in two tiles,
    many equal peaks across a tile edge, and (past one segment) peaks on
    both blind seam columns tied with another column of their tiles and
    with a tile of the next segment."""
    g = torch.Generator(device=dev).manual_seed(seed)
    V = nb * block
    yr = torch.randn(P, V, device=dev, generator=g)
    yi = torch.randn(P, V, device=dev, generator=g)
    scale = torch.rand(2 * P, device=dev, generator=g) + 0.5
    yr[0, 1000:1010] = 6.0  # a plateau: never a peak
    yr[0, 3000] = yr[0, 3000 + 7 * block] = 7.0  # equal, in two tiles
    yi[0, 4000:4600:2] = 5.0  # equal peaks across a tile edge
    seg = K.GROUP * block
    if V > 2 * seg:
        yr[0, seg - 1] = yr[0, seg - 300] = 9.5  # strict seam: earlier wins
        yi[0, seg] = yi[0, seg + 200] = 8.0  # the seam column wins a tie
        yi[0, 2 * seg + 5] = 8.0  # the same height a segment on
    return yr, yi, scale


def _rounds_valid(dev, rows, V, block):
    """valid_len through its edges; the last row a pad row (an odd
    slab's), valid 0."""
    edges = [V, V - 3000, V - 7, 0, block + 1, V + 1, K.GROUP * block + 3]
    vl = [max(edges[r % len(edges)], 0) for r in range(rows)]
    vl[-1] = 0
    return torch.tensor(vl, dtype=torch.int32, device=dev)


def _rounds_equal_plain(planes, scale, vl, distance, n_peaks, block):
    """The rounds kernel against ``_peak_rounds_plain`` on copies of one
    reduction, bit for bit in all three outputs (exhausted slots too); then
    the picker through both routes. Returns the kernel's picks."""
    from audio_matcher_tpu_torch.ops import peaks as TP

    if scale is not None:
        src = TP._PackedPairRows(*planes, scale)
        src_plain = TP._PackedPairRows(*planes, scale, plain=True)
    else:
        src = TP._DenseRows(planes[0])
        src_plain = TP._DenseRows(planes[0], plain=True)
    reduced = src.block_reduce(vl, block)
    before = K.peak_rounds.launches
    got = K.peak_rounds(planes, scale, vl, [t.clone() for t in reduced],
                        distance, n_peaks, block)
    assert K.peak_rounds.launches == before + 1
    want = TP._peak_rounds_plain(src, vl, [t.clone() for t in reduced],
                                 distance, n_peaks, block)
    _bitwise(got, want)
    fused = TP._pick_peaks_from_source(src, vl, distance, n_peaks, block)
    plain = TP._pick_peaks_from_source(src_plain, vl, distance, n_peaks,
                                       block)
    _bitwise(fused, got)
    _bitwise(plain, got)
    return got


def _rounds_both_modes(yr, yi, scale, vl, distance, n_peaks, block):
    """Packed over the planes, dense over the same logical rows: both equal
    to plain, and to each other."""
    packed = _rounds_equal_plain((yr, yi), scale, vl, distance, n_peaks,
                                 block)
    x = K._logical_rows(yr, yi, scale).contiguous()
    dense = _rounds_equal_plain((x,), None, vl, distance, n_peaks, block)
    _bitwise(dense, packed)
    return packed


@pytest.mark.parametrize("P", [4, 16], ids=["snippet_1h", "batch_scan"])
def test_peak_rounds_at_the_cells_shapes_equal_plain(dev, P):
    """NB 5248 and 8 or 32 logical rows, n_peaks 2, the cells' distance:
    the shared layout; the second slot of every row exhausted."""
    assert K.rounds_layout(CELL_NB, 2)
    yr, yi, scale = _rounds_planes(dev, P, P, CELL_NB, 512)
    vl = _rounds_valid(dev, 2 * P, CELL_NB * 512, 512)
    pos, h, _ = _rounds_both_modes(yr, yi, scale, vl, CELL_DISTANCE, 2, 512)
    assert torch.isfinite(h[0, 0]) and torch.isneginf(h[:, 1]).all()
    assert torch.isneginf(h[-1]).all()  # the pad row


@pytest.mark.parametrize(
    "nb,block,distance,n_peaks",
    [
        (300, 512, 100, 64),  # many rounds, rescans within one tile
        (300, 512, 1, 16),  # distance 1: nothing suppressed
        (300, 512, 40 * 512 + 17, 8),  # an interval of ~80 tiles
        (300, 128, 300, 64),  # narrow tiles, intervals over three
        (260, 256, 10**7, 3),  # one pick empties the row
    ],
)
def test_peak_rounds_equal_plain(dev, nb, block, distance, n_peaks):
    """Many rounds and rescans that interact, intervals over many tiles,
    ties in different tiles and across a seam, plateaus, pad rows."""
    yr, yi, scale = _rounds_planes(dev, nb + distance, 3, nb, block)
    vl = _rounds_valid(dev, 6, nb * block, block)
    _rounds_both_modes(yr, yi, scale, vl, distance, n_peaks, block)


@pytest.mark.parametrize("distance,n_peaks", [(CELL_DISTANCE, 3),
                                              (5000, 16)])
def test_peak_rounds_in_place_past_shared_memory(dev, distance, n_peaks):
    """The 2^25 shape (600 s chunks: 51712 tiles a row), past shared
    memory: the rounds work in place on the reduction's outputs."""
    nb = 51712
    assert not K.rounds_layout(nb, n_peaks)
    yr, yi, scale = _rounds_planes(dev, 25, 1, nb, 512)
    vl = torch.tensor([nb * 512 - 9000, nb * 512], dtype=torch.int32,
                      device=dev)
    _rounds_both_modes(yr, yi, scale, vl, distance, n_peaks, 512)


def test_picker_launches_two_kernels_a_slab(dev, monkeypatch):
    """``pick_peaks_packed`` and ``pick_peaks_dense`` on CUDA rows: the
    reduction and the rounds kernel, one launch each, and none of the
    plain rounds' torch ops (each of their functions refuses to run)."""
    from audio_matcher_tpu_torch.ops import peaks as TP

    def refuse(*args, **kwargs):
        raise AssertionError("the plain rounds ran on CUDA rows")

    for name in ("_peak_rounds_plain", "_merge_seams", "_rescan_tile",
                 "_prominences_from_blocks"):
        monkeypatch.setattr(TP, name, refuse)
    yr, yi, scale = _rounds_planes(dev, 3, 4, CELL_NB, 512)
    vl = _rounds_valid(dev, 8, CELL_NB * 512, 512)
    x = K._logical_rows(yr, yi, scale).contiguous()
    for reduce, pick in (
        (K.local_max_block_reduce_packed,
         lambda: TP.pick_peaks_packed(yr, yi, scale, vl, CELL_DISTANCE, 2,
                                      2048)),
        (K.local_max_block_reduce,
         lambda: TP.pick_peaks_dense(x, vl, CELL_DISTANCE, 2, 2048)),
    ):
        before = reduce.launches, K.peak_rounds.launches
        pos, h, prom = pick()
        assert (reduce.launches, K.peak_rounds.launches) == (
            before[0] + 1, before[1] + 1)
        assert pos.is_cuda and torch.isfinite(h[0, 0])


def _offset_windows(ep, off, rows, W, chunk):
    """[rows, W] windows of ``ep`` ``chunk`` apart, starting ``off``
    elements in: row starts at every alignment."""
    return ep[off:].as_strided((rows, W), (chunk, 1))


@pytest.mark.parametrize("n", SIZES + [1 << 26])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.float32])
def test_wire_passes_at_every_row_alignment_match_plain(dev, n, dtype):
    """Kernels 1 and 6 on 3 windows (odd P) whose starts sit 0-15 bytes off
    a 16-byte boundary, an odd chunk apart; kernel 6 with 1 and 3 odd
    windows; at 2^26 on the clusters' copies of rows b + K·a1."""
    g = torch.Generator(device=dev).manual_seed(n + dtype.itemsize)
    A, M = F.split_factors(n)
    P, chunk = 3, int(0.6 * n) + 1
    size = dtype.itemsize
    ep = _wire_episode(dev, g, dtype, (P - 1) * chunk + n + 16)
    for off in range(16 // size):
        win = _offset_windows(ep, off, P, n, chunk)
        assert win.data_ptr() % 16 == off * size
        _close(F.fft_major_fwd_wire(win, A, n, n - 1),
               F.fft_major_fwd_wire_plain(win, A, n, n - 1))
        for p1 in (1, P):
            _close(F.fft_major_fwd_wire2(win, win[:p1], A, n, n - 1),
                   F.fft_major_fwd_wire2_plain(win, win[:p1], A, n, n - 1))


@pytest.mark.parametrize("n", SIZES + [1 << 26, 1 << 28])
def test_wire_passes_at_strip_and_row_edges_match_plain(dev, n):
    """w_len on a row edge (a * M), on a strip edge (+ C), one short of
    it, and 5 samples: the points past it read as zero (on a cluster, a
    row edge inside one block's rows b + K·a1)."""
    g = torch.Generator(device=dev).manual_seed(n + 3)
    A, M = F.split_factors(n)
    C = 1 << F.fft_plan.major_strip_log2(A.bit_length() - 1)
    a = A // 2 + 1
    ep = _wire_episode(dev, g, torch.uint8, 2 * n + 16)
    win = _offset_windows(ep, 3, 3, n, n // 2 + 3)
    for w_len in (a * M, a * M + C, a * M + C - 1, 5):
        _close(F.fft_major_fwd_wire(win, A, n, w_len),
               F.fft_major_fwd_wire_plain(win, A, n, w_len))
        _close(F.fft_major_fwd_wire2(win, win[:2], A, n, w_len),
               F.fft_major_fwd_wire2_plain(win, win[:2], A, n, w_len))


def _staged_rows(eps, rows, width, silence):
    want = np.full((rows, width), silence, eps[0].dtype)
    for i, e in enumerate(eps):
        want[i, : len(e)] = e
    return want


def test_pinned_staging_through_the_copy_stream(dev):
    """20 groups staged back to back from fresh pinned buffers, each upload
    on the side stream without a host synchronization: every staged
    tensor equals its host rows bit for bit, though the next group's rows
    are written while the last copy may still run (the caching host
    allocator hands a buffer out again only after its copy completed)."""
    from audio_matcher_tpu_torch.models.matcher import (
        side_stream, stage_rows_host, wire_silence)

    rng = np.random.default_rng(1)
    rows, width = 4, 1 << 22  # 32 MB of int16 a group
    groups = [[rng.integers(-30000, 30000, int(rng.integers(width // 4,
                                                            width)),
                            dtype=np.int16) for _ in range(rows - k % 2)]
              for k in range(20)]
    staged, busy = [], 0
    torch.cuda.synchronize()
    for k, eps in enumerate(groups):
        if k:
            busy += not side_stream(dev).query()
        out = stage_rows_host(eps, [len(e) for e in eps], width, "int16",
                              rows, dev)
        staged.append(out[0])
    torch.cuda.synchronize()
    silence = wire_silence("int16")
    for got, eps in zip(staged, groups):
        assert np.array_equal(got.cpu().numpy(),
                              _staged_rows(eps, rows, width, silence))
    assert busy > 0  # some copy was still running when the next group came


def test_a_split_fill_is_uploaded_whole(dev, monkeypatch):
    """A group whose fill is cut into 1 MiB parts on 4 threads, one part
    slow: ``stage_rows_host`` returns only after every part is written
    (each copied as soon as it and the parts before it were), and the
    staged tensor equals the host rows bit for bit."""
    from audio_matcher_tpu_torch.models import matcher

    monkeypatch.setattr(matcher, "FILL_PART_BYTES", 1 << 20)
    monkeypatch.setattr(matcher._FillPool, "threads", 4)
    monkeypatch.setattr(matcher._FillPool, "pool", None)
    fill_range, done = matcher._fill_range, []

    def slow_last(out, eps, start, stop, transfer):
        if stop == out.size:
            time.sleep(0.3)
        fill_range(out, eps, start, stop, transfer)
        done.append(start)

    monkeypatch.setattr(matcher, "_fill_range", slow_last)
    rng = np.random.default_rng(2)
    rows, width = 3, 1 << 22  # 8 MB of int16 a row: 24 parts
    eps = [rng.integers(-30000, 30000, n, dtype=np.int16)
           for n in (width, width - 4097)]
    plan = matcher.fill_plan(rows, width, 2)
    try:
        staged = matcher.stage_rows_host(eps, [len(e) for e in eps], width,
                                         "int16", rows, dev)[0]
        assert sorted(done) == [a for a, _ in plan] and len(plan) == 24
        torch.cuda.synchronize()
        assert np.array_equal(staged.cpu().numpy(), _staged_rows(
            eps, rows, width, matcher.wire_silence("int16")))
    finally:
        if matcher._FillPool.pool is not None:
            matcher._FillPool.pool.shutdown()


@pytest.fixture
def small_parts(monkeypatch):
    """Fills cut into parts of 64 KiB, on a fresh pool of 4 threads."""
    from audio_matcher_tpu_torch.models import matcher

    monkeypatch.setattr(matcher, "FILL_PART_BYTES", 64 << 10)
    monkeypatch.setattr(matcher._FillPool, "threads", 4)
    monkeypatch.setattr(matcher._FillPool, "pool", None)
    yield matcher
    if matcher._FillPool.pool is not None:
        matcher._FillPool.pool.shutdown()


@pytest.mark.parametrize("wire", ["float32", "int16", "mulaw8"])
def test_part_wise_staging_equals_one_copy_upload(dev, small_parts, wire):
    """Rows staged part by part as they fill (two episodes in four rows,
    the last two rows past the episodes) equal, bit for bit, the rows
    filled whole and uploaded with one copy, read on the current stream
    straight after staging with no synchronization."""
    matcher = small_parts
    rng = np.random.default_rng(3)
    rows, width = 4, 300_001
    eps = [quantize_wire((rng.standard_normal(n) * 0.1).astype(np.float32),
                         wire) for n in (width, 123_457)]
    itemsize = np.dtype(matcher.WIRE_DTYPES[wire]).itemsize
    assert len(matcher.fill_plan(rows, width, itemsize)) >= 4
    want = matcher.upload(matcher.fill_wire_rows(eps, width, wire, rows,
                                                 pinned=True), dev)
    for _ in range(3):
        staged, ns_pad, n = matcher.stage_rows_host(
            eps, [len(e) for e in eps], width, wire, rows, dev)
        assert torch.equal(staged, want)
        assert list(ns_pad) == [width, 123_457, 0, 0] and n == 2
    assert torch.equal(want[2:].cpu(), torch.from_numpy(np.full(
        (2, width), matcher.wire_silence(wire),
        matcher.WIRE_DTYPES[wire])))


def test_live_match_after_part_wise_staging_returns_todays_peaks(
        dev, small_parts, monkeypatch):
    """``SnippetMatcher.match`` on the live path (a progress callback,
    float32 wire) stages an episode in parts and scans it at once: the
    peaks equal those of a fill of one range, copied once after it."""
    matcher = small_parts
    parts = []
    in_parts = matcher.upload_while_filling

    def counted(episodes, n_pad, transfer, rows, device):
        parts.append(len(matcher.fill_plan(rows, n_pad, 4)))
        return in_parts(episodes, n_pad, transfer, rows, device)

    monkeypatch.setattr(matcher, "upload_while_filling", counted)
    sr = 8000
    rng = np.random.default_rng(17)
    snippet = (rng.standard_normal(4000) * 0.2).astype(np.float32)
    ep = (rng.standard_normal(61 * sr) * 0.05).astype(np.float32)
    for at in (5.0, 31.5, 50.0):
        ep[int(at * sr) : int(at * sr) + 4000] += snippet
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0, slab=4,
                      slab_auto=False, progress_slabs_per_dispatch=2,
                      transfer_dtype="float32")
    m = SnippetMatcher(snippet, sr, cfg, device=dev)
    got = [m.match(ep, progress=lambda p, k: None) for _ in range(3)]
    monkeypatch.setattr(matcher, "FILL_PART_BYTES", 1 << 40)  # one range
    want = m.match(ep, progress=lambda p, k: None)
    assert len(parts) == 4 and min(parts[:3]) > 1 and parts[3] == 1
    assert got == [want] * 3
    assert [p.position for p in want] == [int(a * sr)
                                          for a in (5.0, 31.5, 50.0)]


@pytest.mark.parametrize("pad_to", [None, 4])
def test_stage_resident_on_cuda_equals_cpu(dev, pad_to):
    """The staged tensor through the side stream equals the CPU staging."""
    sr = 8000
    rng = np.random.default_rng(6)
    snippets = [(rng.standard_normal(4000) * 0.2).astype(np.float32)] * 2
    scanner = ShardedScanner(snippets, sr, MatchConfig(
        chunk_secs=1.0, transfer_dtype="mulaw8"), device=dev)
    cpu = ShardedScanner(snippets, sr, scanner.config, device="cpu")
    for lengths in ((9.5, 3.0), (2.0,), (12.25, 1.0, 7.0)):
        eps = [quantize_wire((rng.standard_normal(int(s * sr)) * 0.05)
                             .astype(np.float32), "mulaw8") for s in lengths]
        got = scanner.stage_resident(eps, pad_to)
        want = cpu.stage_resident(eps, pad_to)
        assert got[0].is_cuda and torch.equal(got[0].cpu(), want[0])
        assert np.array_equal(got[1], want[1]) and got[2] == want[2]


def test_sweep_archive_on_cuda_matches_cpu(dev, tmp_path):
    """``sweep_archive`` over a small wav directory (mixed durations, a
    corrupt file, groups of 2 with a tail) on the card, with the kernels
    of the fused path launched, gives the CPU run's label files and
    ``.done.txt``."""
    from audio_matcher_tpu_torch.hostio.decode import write_wav
    from audio_matcher_tpu_torch.hostio.labels import (
        timelabel_from_peaks, write_labels)
    from audio_matcher_tpu_torch.parallel.sweep import sweep_archive

    sr = 8000
    rng = np.random.default_rng(13)
    snippets = [(rng.standard_normal(m) * 0.2).astype(np.float32)
                for m in (4000, 3600, 3800)]
    paths = []
    for e, secs in enumerate((9.0, 4.5, 13.0, 6.0, 7.5)):
        ep = (rng.standard_normal(int(secs * sr)) * 0.05).astype(np.float32)
        for q, at in ((e % 3, 1.0), ((e + 1) % 3, secs - 2.5)):
            ep[int(at * sr) : int(at * sr) + len(snippets[q])] = snippets[q]
        paths.append(tmp_path / f"ep{e}.wav")
        write_wav(paths[-1], sr, ep)
    (tmp_path / "ep9.wav").write_bytes(rng.bytes(2000))
    paths.insert(2, tmp_path / "ep9.wav")
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0,
                      transfer_dtype="int16")
    path = (F.fft_major_fwd_wire, F.fft_minor, F.ifft_minor_product,
            F.fft_major, K.local_max_block_reduce_packed)
    outs = {}
    for name, device in (("cuda", dev), ("cpu", "cpu")):
        out = tmp_path / name
        out.mkdir()

        def sink(p, q, peaks, out=out):
            write_labels(timelabel_from_peaks(peaks, sr),
                         out / f"{p.stem}.q{q}.txt")

        before = [k.launches for k in path]
        outs[name] = sweep_archive(paths, snippets, sr, cfg, device=device,
                                   progress_path=out / ".done.txt",
                                   write_labels_for=sink, group_size=2)
        launched = [k.launches - b for k, b in zip(path, before)]
        assert all(launched) == (name == "cuda"), launched
    assert list(outs["cuda"]) == list(outs["cpu"]) and len(outs["cpu"]) == 5
    names = sorted(p.name for p in (tmp_path / "cpu").iterdir())
    assert len(names) == 16
    for n in names:
        got = (tmp_path / "cuda" / n).read_bytes()
        assert got == (tmp_path / "cpu" / n).read_bytes(), n
    for p in paths:
        if p.name != "ep9.wav":
            assert outs["cuda"][str(p)][0] or outs["cuda"][str(p)][1]


def _noise_fps(seed, t_e, t_ss, m=64):
    """Log-mel-like fingerprints: mean -6, spread 3, like noisy audio."""
    rng = np.random.default_rng(seed)
    ep = (rng.standard_normal((t_e, m)) * 3 - 6).astype(np.float32)
    snips = np.zeros((len(t_ss), max(t_ss), m), np.float32)
    for q, t_s in enumerate(t_ss):
        snips[q, :t_s] = ep[1000 + 37 * q : 1000 + 37 * q + t_s]
    return ep, snips


def test_spectrogram_scores_on_cuda_match_cpu(dev):
    """The frame NCC over full 65536-frame tiles (the f32 box-filter
    cancellation the float64 statistics avoid) and a spectrogram scan on
    the card: scores within 2e-4 of the CPU path, peaks at the same
    frames."""
    from audio_matcher_tpu_torch.models.spectrogram import SpectrogramConfig
    from audio_matcher_tpu_torch.ops.stft import ncc_frames_multi_core
    from audio_matcher_tpu_torch.parallel.sweep import (
        ShardedSpectrogramScanner)

    t_ss = (1719, 2322, 1900)
    ep, snips = _noise_fps(3, 150000, t_ss)
    want = ncc_frames_multi_core(torch.from_numpy(ep), torch.from_numpy(snips),
                                 t_ss)
    got = ncc_frames_multi_core(torch.from_numpy(ep).to(dev),
                                torch.from_numpy(snips).to(dev), t_ss).cpu()
    for q, t_s in enumerate(t_ss):
        v = ep.shape[0] - t_s + 1
        assert (got[q, :v] - want[q, :v]).abs().max().item() < 2e-4
    sr = 44100
    rng = np.random.default_rng(4)
    snippet = (rng.standard_normal(10 * sr) * 0.15).astype(np.float32)
    episodes = []
    for at in (30.0, 200.0):
        x = (rng.standard_normal(300 * sr) * 0.05).astype(np.float32)
        x[int(at * sr) : int(at * sr) + len(snippet)] += snippet
        episodes.append(x)
    cfg = SpectrogramConfig(distance_secs=60.0, transfer_dtype="int16")
    peaks = {name: ShardedSpectrogramScanner([snippet], sr, cfg, device=d)
             .scan_resident(episodes) for name, d in (("cuda", dev),
                                                      ("cpu", "cpu"))}
    for g, w in zip(peaks["cuda"], peaks["cpu"]):
        assert [p.position for p in g[0]] == [p.position for p in w[0]]
        assert all(abs(a.height - b.height) < 2e-4 for a, b in zip(g[0], w[0]))
    for e, at in zip(peaks["cuda"], (30.0, 200.0)):  # within one hop
        assert abs(max(e[0], key=lambda p: p.height).position
                   - int(at * sr)) <= cfg.hop


def test_device_resample_on_cuda_matches_scipy(dev):
    """600 s of 48 kHz noise to 44.1 kHz on the card: within 2e-6 of
    scipy's float64 resample_poly, the int16 wire within 1."""
    import scipy.signal

    from audio_matcher_tpu_torch.ops.resample import resample_poly_device

    x = (np.random.default_rng(5).standard_normal(600 * 48000) * 0.1).astype(
        np.float32)
    want = scipy.signal.resample_poly(x.astype(np.float64), 147, 160).astype(
        np.float32)
    got = resample_poly_device(x, 48000, 44100, device=dev)
    assert got.is_cuda and tuple(got.shape) == want.shape
    assert np.abs(got.cpu().numpy() - want).max() < 2e-6
    w = resample_poly_device(x, 48000, 44100, wire_int16=True, device=dev)
    q = np.clip(np.round(want * 65535.0), -32768, 32767).astype(np.int32)
    assert np.abs(w.cpu().numpy().astype(np.int32) - q).max() <= 1


def test_device_resample_ignores_the_callers_tf32(dev):
    """With the caller's TF32 on (matmul and cuDNN), the resample gives the
    same bits as with it off, and the caller's settings survive."""
    from audio_matcher_tpu_torch.ops.resample import resample_poly_device

    x = (np.random.default_rng(6).standard_normal(30 * 22050) * 0.1).astype(
        np.float32)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        off = resample_poly_device(x, 22050, 44100, device=dev)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        on = resample_poly_device(x, 22050, 44100, device=dev)
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        assert torch.equal(on, off)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.set_float32_matmul_precision(prev[2])


def test_matcher_cli_on_cuda_then_worker_equals_cpu_chain(dev, tmp_path,
                                                          monkeypatch):
    """The workflow's first two tools: the matcher CLI on the card writes
    the label file that the port's worker names, merges, tags and files
    against the fake Audacity. The final tree equals the same chain's
    with ``--device cpu``, byte for byte."""
    import io

    from audio_matcher_tpu_torch.cli import matcher_cli, worker_cli
    from audio_matcher_tpu_torch.hostio.decode import write_wav
    from audio_matcher_tpu_torch.hostio.labels import read_labels
    from audio_matcher_tpu_torch.worker.fake_audacity import FakeAudacity

    sr = 8000
    rng = np.random.default_rng(21)
    snippet = (rng.standard_normal(2 * sr) * 0.2).astype(np.float32)
    episode = (rng.standard_normal(70 * sr) * 0.02).astype(np.float32)
    for at in (5, 25, 45):
        episode[at * sr : at * sr + len(snippet)] = snippet
    trees = {}
    for side in ("cuda", "cpu"):
        root = tmp_path / side
        (root / "archive" / "Serie").mkdir(parents=True)
        (root / "archive" / "Serie" / "index.txt").write_text("Eins\n")
        work = root / "work"
        work.mkdir()
        write_wav(root / "intro.wav", sr, snippet)
        write_wav(work / "radio-2024_01_06.wav", sr, episode)
        (work / "Serie 1 Eins.mp3").write_bytes(
            b"\xff\xfb\x90\x00" + bytes(413))
        assert matcher_cli.main([
            str(work / "radio-2024_01_06.wav"), "--snippet",
            str(root / "intro.wav"), "--distance", "10", "--chunk-size",
            "10", "--device", str(dev) if side == "cuda" else "cpu",
            "--silent"]) == 0
        assert len(read_labels(work / "radio-2024_01_06.txt")) == 2
        monkeypatch.chdir(root)
        monkeypatch.setenv("AUDACITY_PIPE_DIR", str(root / "pipes"))
        monkeypatch.setattr("sys.stdin", io.StringIO("\nSerie 1\nSerie 1\n\n\n"))
        server = FakeAudacity(root / "pipes")
        try:
            assert worker_cli.main([
                "work/radio-2024_01_06.wav", "--index-folder", "archive",
                "--config", "w.toml", "-n", "--silent",
                "--timeout", "10"]) == 0
        finally:
            server.stop()
        trees[side] = {
            str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and p.suffix != ".wav"}
    assert trees["cuda"] == trees["cpu"]
    assert "archive/Serie/Serie 1 Eins.mp3" in trees["cuda"]
    assert b"Serie 1.2 Eins" in trees["cuda"]["work/radio-2024_01_06.txt"]


# ------------------------------------------------ the captured scan steps
def _bitwise(got, want):
    """Every output tensor identical, -inf and NaN slots included."""
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(a.cpu().numpy(), b.cpu().numpy(),
                              equal_nan=True)


def _scan_case(n_queries, seed):
    sr = 8000
    rng = np.random.default_rng(seed)
    snippets = [(rng.standard_normal(m) * 0.2).astype(np.float32)
                for m in (4000, 3600, 3800)][:n_queries]
    batches = []
    for _ in range(2):
        eps = [(rng.standard_normal(secs * sr) * 0.05).astype(np.float32)
               for secs in (20, 17)]
        for e, ep in enumerate(eps):
            at = int((3.0 + 5 * e + rng.uniform(0, 2)) * sr)
            ep[at : at + 4000] = snippets[0]
        batches.append([quantize_wire(ep, "mulaw8") for ep in eps])
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0,
                      transfer_dtype="mulaw8")
    return sr, snippets, batches, cfg


def _launch_counts():
    return [k.launches for k in F.KERNELS + K.KERNELS]


@pytest.mark.parametrize("n_queries", [3, 1])
def test_graphed_scan_equals_eager_bitwise(dev, n_queries):
    """``resident_match_step`` replayed as a CUDA graph: every output equal
    to the eager step's, bit for bit, on its first sight (eager), its
    capture and a replay; two stagings of one key each get their own
    candidates; two groups dispatched ahead (the sweep's pipeline) keep
    theirs; each run counts the same launches as the eager scan."""
    sr, snippets, batches, cfg = _scan_case(n_queries, 12)
    graphed = ShardedScanner(snippets, sr, cfg, device=dev)
    eager = ShardedScanner(snippets, sr, cfg, device=dev, graphs=False,
                           query_state=graphed.query_state)
    assert eager.step_graphs is None
    staged = [graphed.stage_resident(b) for b in batches]
    want, per_run = [], []
    for s in staged:
        before = _launch_counts()
        want.append(eager.scan_dispatch(s))
        per_run.append([a - b for a, b in zip(_launch_counts(), before)])
    assert per_run[0] == per_run[1] and any(per_run[0])
    for k in (0, 1, 0, 1):  # first sight, capture, two replays
        before = _launch_counts()
        got = graphed.scan_dispatch(staged[k])
        assert [a - b for a, b in zip(_launch_counts(), before)] == (
            per_run[k])
        _bitwise(got[0], want[k][0])
    assert dict(graphed.step_graphs.stats) == {"first": 1, "captures": 1,
                                               "hits": 2}
    ahead = [graphed.scan_dispatch(s) for s in staged]  # g+1 before g read
    for d, w in zip(ahead, want):
        assert graphed.scan_collect(d) == eager.scan_collect(w)
    assert graphed.scan_collect(ahead[0])[0][0]  # the plant, found


def test_graphed_matcher_equals_eager_bitwise(dev):
    """``SnippetMatcher.match_staged`` replayed as a CUDA graph: the raw
    candidates and the peaks of two stagings equal the eager matcher's,
    bit for bit, with the same launches a run."""
    sr = 8000
    rng = np.random.default_rng(14)
    snippet = (rng.standard_normal(4000) * 0.2).astype(np.float32)
    eps = []
    for at in (5.0, 9.5):
        ep = (rng.standard_normal(21 * sr) * 0.05).astype(np.float32)
        ep[int(at * sr) : int(at * sr) + 4000] = snippet
        eps.append(ep)
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0,
                      transfer_dtype="int16")
    graphed = SnippetMatcher(snippet, sr, cfg, device=dev)
    eager = SnippetMatcher(snippet, sr, cfg, device=dev, graphs=False)
    staged = [graphed.stage(ep) for ep in eps]
    n_pad = (staged[0][0].shape[0] - graphed.overlap) // graphed.chunk
    slab = scan_slab(cfg, graphed.chunk, staged[0][1], n_pad)

    def raw(m, s):
        return m._scan(s[0][None], [s[1]], True, slab, n_pad // slab)

    for k in (0, 1, 0, 1):
        before = _launch_counts()
        want = raw(eager, staged[k])
        eager_launches = [a - b for a, b in zip(_launch_counts(), before)]
        before = _launch_counts()
        got = raw(graphed, staged[k])
        assert [a - b for a, b in zip(_launch_counts(), before)] == (
            eager_launches)
        _bitwise(got, want)
        assert graphed.match_staged(staged[k]) == eager.match_staged(
            staged[k])
    assert graphed.step_graphs.stats["hits"] >= 2
    assert [p.position for p in graphed.match_staged(staged[1])] == [
        int(9.5 * sr)]


def test_graphed_step_runs_the_rounds_once_a_slab(dev):
    """The resident step with the rounds kernel: a replayed graph gives the
    eager step's picks bit for bit, and each run launches the rounds once a
    slab (as the reduction)."""
    sr = 8000
    rng = np.random.default_rng(27)
    snippet = (rng.standard_normal(4000) * 0.2).astype(np.float32)
    ep = (rng.standard_normal(37 * sr) * 0.05).astype(np.float32)
    ep[int(6.5 * sr) : int(6.5 * sr) + 4000] = snippet
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0, slab=4,
                      slab_auto=False, transfer_dtype="float32")
    graphed = SnippetMatcher(snippet, sr, cfg, device=dev)
    eager = SnippetMatcher(snippet, sr, cfg, device=dev, graphs=False)
    staged = graphed.stage(ep)
    n_pad = (staged[0].shape[0] - graphed.overlap) // graphed.chunk
    slab = scan_slab(cfg, graphed.chunk, staged[1], n_pad)
    slabs = n_pad // slab
    assert slabs > 1

    def raw(m):
        before = K.peak_rounds.launches, K.local_max_block_reduce_packed.launches
        out = m._scan(staged[0][None], [staged[1]], True, slab, slabs)
        return out, (K.peak_rounds.launches - before[0],
                     K.local_max_block_reduce_packed.launches - before[1])

    want, launched = raw(eager)
    assert launched == (slabs, slabs)
    for _ in range(3):  # first sight, capture, replay
        got, launched = raw(graphed)
        assert launched == (slabs, slabs)
        _bitwise(got, want)
    assert graphed.step_graphs.stats["hits"] >= 1
    assert [p.position for p in graphed.match_staged(staged)] == [
        int(6.5 * sr)]


def test_graphed_spectrogram_scan_equals_eager_bitwise(dev):
    """The spectrogram step replayed as a CUDA graph: every output equal
    to the eager step's, bit for bit, no kernel of ours launched."""
    from audio_matcher_tpu_torch.models.spectrogram import SpectrogramConfig
    from audio_matcher_tpu_torch.parallel.sweep import (
        ShardedSpectrogramScanner)

    sr = 44100
    rng = np.random.default_rng(15)
    snippet = (rng.standard_normal(10 * sr) * 0.15).astype(np.float32)
    episodes = []
    for at in (30.0, 200.0):
        x = (rng.standard_normal(300 * sr) * 0.05).astype(np.float32)
        x[int(at * sr) : int(at * sr) + len(snippet)] += snippet
        episodes.append(x)
    cfg = SpectrogramConfig(distance_secs=60.0, transfer_dtype="int16")
    graphed = ShardedSpectrogramScanner([snippet], sr, cfg, device=dev)
    eager = ShardedSpectrogramScanner([snippet], sr, cfg, device=dev,
                                      graphs=False,
                                      query_fps=graphed.query_fps.cpu())
    staged = graphed.stage_resident(episodes)
    want = eager.scan_dispatch(staged)
    before = _launch_counts()
    for _ in range(3):
        _bitwise(graphed.scan_dispatch(staged)[0], want[0])
    assert _launch_counts() == before
    assert dict(graphed.step_graphs.stats) == {"first": 1, "captures": 1,
                                               "hits": 1}
    peaks = graphed.scan_resident(episodes)
    for e, at in zip(peaks, (30.0, 200.0)):
        assert abs(max(e[0], key=lambda p: p.height).position
                   - int(at * sr)) <= cfg.hop


def test_a_step_that_syncs_raises_at_capture(dev):
    """A step that reads a value back (``.item()``) runs on its key's
    first sight, then its capture raises, and so does every later call of
    the key: nothing runs it eagerly in its place, no graph is kept, and
    the card goes on working."""
    from audio_matcher_tpu_torch.parallel import step_graph

    cache = step_graph.StepGraphs()
    entered = []

    def step(x):
        entered.append(True)
        return (x * x.sum().item(),)

    x = torch.ones(4, device=dev)
    assert torch.equal(cache("k", step, (x,))[0].cpu(), torch.full((4,), 4.))
    for _ in range(2):  # the caller retries: raises again
        with pytest.raises(RuntimeError):
            cache("k", step, (x,))
    assert len(entered) == 3
    assert not any(k[0] is cache._token
                   for k in step_graph._DEVICES[dev].graphs)
    assert dict(cache.stats) == {"first": 1}
    assert torch.equal((x + 1).cpu(), torch.full((4,), 2.0))
    ok = cache("j", lambda t: (t * 3,), (x,))  # later captures still work
    ok = cache("j", lambda t: (t * 3,), (x,))
    assert torch.equal(ok[0].cpu(), torch.full((4,), 3.0))
    assert cache.stats["captures"] == 1


def test_graphed_live_path_equals_eager_bitwise(dev):
    """The live-progress path (the matcher CLI's, a group of slabs a
    call) of one matcher over three episodes: every group after the first
    two of each shape replays, the peaks equal the eager matcher's and the
    one-call path's, with the same launches an episode."""
    sr = 8000
    rng = np.random.default_rng(16)
    snippet = (rng.standard_normal(4000) * 0.2).astype(np.float32)
    eps = []
    for at in (5.0, 31.5, 50.0):
        ep = (rng.standard_normal(61 * sr) * 0.05).astype(np.float32)
        ep[int(at * sr) : int(at * sr) + 4000] = snippet
        eps.append(ep)
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0, slab=4,
                      slab_auto=False, progress_slabs_per_dispatch=2,
                      transfer_dtype="mulaw8")
    graphed = SnippetMatcher(snippet, sr, cfg, device=dev)
    eager = SnippetMatcher(snippet, sr, cfg, device=dev, graphs=False)
    for ep, at in zip(eps, (5.0, 31.5, 50.0)):
        before = _launch_counts()
        want = eager.match(ep, progress=lambda p, k: None)
        eager_launches = [a - b for a, b in zip(_launch_counts(), before)]
        before = _launch_counts()
        got = graphed.match(ep, progress=lambda p, k: None)
        assert [a - b for a, b in zip(_launch_counts(), before)] == (
            eager_launches)
        assert got == want == eager.match(ep)
        assert [p.position for p in got] == [int(at * sr)]
    # 61 windows → 16 slabs of 4: 8 full groups an episode, one key
    assert dict(graphed.step_graphs.stats) == {"first": 1, "captures": 1,
                                               "hits": 22}


def test_graphed_caches_share_one_pool(dev):
    """Two scanners' graphs on one card: one memory pool between them."""
    from audio_matcher_tpu_torch.parallel import step_graph

    sr, snippets, batches, cfg = _scan_case(3, 17)
    a = ShardedScanner(snippets, sr, cfg, device=dev)
    b = ShardedScanner(snippets[:1], sr, cfg, device=dev)
    for scanner in (a, b):
        staged = scanner.stage_resident(batches[0])
        for _ in range(3):
            scanner.scan_dispatch(staged)
        assert scanner.step_graphs.stats["hits"] == 1
    store = step_graph._DEVICES[dev]
    mine = [e for k, e in store.graphs.items()
            if k[0] in (a.step_graphs._token, b.step_graphs._token)]
    assert len(mine) == 2
    assert {e.graph.pool() for e in mine} == {store.pool}


def _refusing_graph(monkeypatch):
    """Every capture of the step cache refuses, as a capture that meets a
    host read does."""
    from audio_matcher_tpu_torch.parallel import step_graph

    class Refusing(step_graph.CudaGraph):
        def capture(self, run, device, pool):
            raise RuntimeError("operation not permitted when capturing")

    monkeypatch.setattr(step_graph, "CudaGraph", Refusing)


def _fresh_call_graphs(monkeypatch):
    """A cache of its own for ``match()`` and ``calc_chunks``."""
    from audio_matcher_tpu_torch.models import matcher as TM
    from audio_matcher_tpu_torch.parallel.step_graph import StepGraphs

    cache = StepGraphs()
    monkeypatch.setattr(TM, "CALL_GRAPHS", cache)
    return cache


def _single_case(seed, secs=21, plants=(5.0, 9.5)):
    sr = 8000
    rng = np.random.default_rng(seed)
    snippet = (rng.standard_normal(4000) * 0.2).astype(np.float32)
    eps = []
    for at in plants:
        ep = (rng.standard_normal(secs * sr) * 0.05).astype(np.float32)
        ep[int(at * sr) : int(at * sr) + 4000] = snippet
        eps.append(ep)
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0,
                      transfer_dtype="mulaw8")
    return sr, snippet, eps, cfg


def test_graphed_batch_matcher_equals_eager_bitwise(dev):
    """``SnippetMatcher.match_staged_batch`` replayed as a CUDA graph: the
    raw candidates and the peaks of two stagings of one shape equal the
    eager matcher's, bit for bit, with the same launches a run."""
    sr, snippet, eps, cfg = _single_case(18, plants=(5.0, 9.5, 14.0, 3.0))
    graphed = SnippetMatcher(snippet, sr, cfg, device=dev)
    eager = SnippetMatcher(snippet, sr, cfg, device=dev, graphs=False)
    staged = [graphed.stage_batch(eps[:2]), graphed.stage_batch(eps[2:])]
    n_pad = (staged[0][0].shape[1] - graphed.overlap) // graphed.chunk
    slab = scan_slab(cfg, graphed.chunk, int(staged[0][1].max()), n_pad)

    def raw(m, s):
        return m._scan(*s, True, slab, n_pad // slab)

    for k in (0, 1, 0, 1):
        before = _launch_counts()
        want = raw(eager, staged[k])
        eager_launches = [a - b for a, b in zip(_launch_counts(), before)]
        before = _launch_counts()
        got = raw(graphed, staged[k])
        assert [a - b for a, b in zip(_launch_counts(), before)] == (
            eager_launches)
        _bitwise(got, want)
    assert dict(graphed.step_graphs.stats) == {"first": 1, "captures": 1,
                                               "hits": 2}
    got = graphed.match_staged_batch(staged[1])
    assert got == eager.match_staged_batch(staged[1])
    assert [[p.position for p in e if p.height > 0.5] for e in got] == [
        [14 * sr], [3 * sr]]


def test_repeated_match_replays_on_the_shared_cache(dev, monkeypatch):
    """``match()`` and ``calc_chunks`` build a matcher a call; from the
    third call of one shape on they replay the shared cache's graph, with
    the eager matcher's peaks bit for bit, also for another snippet of
    the same length (the spectrum is copied into the graph)."""
    from audio_matcher_tpu_torch.models.matcher import calc_chunks

    cache = _fresh_call_graphs(monkeypatch)
    sr, snippet, eps, cfg = _single_case(19)
    other = (np.random.default_rng(24).standard_normal(4000) * 0.2).astype(
        np.float32)  # another snippet of the same length
    ep = eps[0].copy()
    ep[int(14.0 * sr) : int(14.0 * sr) + 4000] = other
    kw = dict(chunk_secs=1.0, distance_secs=2.0, transfer_dtype="mulaw8")
    for k, snip in enumerate((snippet, snippet, snippet, other, snippet)):
        want = SnippetMatcher(snip, sr, MatchConfig(**kw), device=dev,
                              graphs=False).match(ep)
        got = (calc_chunks(sr, ep, snip, config=MatchConfig(**kw),
                           device=dev) if k % 2
               else port.match(snip, ep, sr, device=dev, **kw))
        assert got == want
        assert cache.stats["hits"] == max(k - 1, 0)
        assert [p.position for p in got if p.height > 0.5] == [
            int((14.0 if snip is other else 5.0) * sr)]
    assert dict(cache.stats) == {"first": 1, "captures": 1, "hits": 3}


def _spectrogram_case(seed, secs=300, plants=(40.0, 200.0)):
    sr = 8000
    rng = np.random.default_rng(seed)
    t = np.arange(3 * sr) / sr  # test_torch_spectrogram.py's snippet
    env = np.minimum(1.0, 10 * t) * np.minimum(1.0, 10 * (3 - t))
    snippet = (0.2 * env * sum(np.sin(2 * np.pi * f * t + p) for f, p in
                               [(220, 0.1), (523, 1.0), (1397, 2.0)])
               ).astype(np.float32)
    episode = (rng.standard_normal(secs * sr) * 0.05).astype(np.float32)
    for at in plants:
        episode[int(at * sr) : int(at * sr) + len(snippet)] += snippet
    return sr, snippet, episode


@pytest.mark.parametrize("tile,distance", [(None, 60.0), (2048, 60.0),
                                           (None, 0.01)],
                         ids=["whole", "tiled", "scipy"])
def test_graphed_spectrogram_matcher_equals_eager_bitwise(dev, monkeypatch,
                                                          tile, distance):
    """``SpectrogramMatcher.match`` replayed as a CUDA graph: the step's
    outputs (the picks, or past 256 slots the scores) and the peaks equal
    the eager matcher's, bit for bit, over first sight, capture and
    replay, with the NCC whole and tiled (``NCC_TILE`` made small: the
    tiled path's frame count comes from the device); no kernel of ours
    launched."""
    from audio_matcher_tpu_torch.models.spectrogram import (
        SpectrogramConfig, SpectrogramMatcher)
    from audio_matcher_tpu_torch.ops import stft

    if tile is not None:
        monkeypatch.setattr(stft, "NCC_TILE", tile)
    sr, snippet, episode = _spectrogram_case(20)
    cfg = SpectrogramConfig(distance_secs=distance, min_score=0.5)
    graphed = SpectrogramMatcher(snippet, sr, cfg, device=dev)
    eager = SpectrogramMatcher(snippet, sr, cfg, device=dev, graphs=False)
    assert eager.step_graphs is None
    before = _launch_counts()
    want = eager._picks(episode)
    assert len(want) == (1 if distance < 1 else 3)
    for _ in range(3):
        _bitwise(graphed._picks(episode), want)
    assert dict(graphed.step_graphs.stats) == {"first": 1, "captures": 1,
                                               "hits": 1}
    peaks = graphed.match(episode)
    assert peaks == eager.match(episode)
    assert _launch_counts() == before
    for at in (40.0, 200.0):
        assert any(abs(p.position - int(at * sr)) <= cfg.hop for p in peaks)


def test_graphed_windows_scan_equals_eager_bitwise(dev):
    """The windows path ``scan()`` replayed as a CUDA graph a block: each
    block's outputs and the peaks equal the eager scanner's, bit for bit,
    scaled and unscaled (one graph: the scales are copied in)."""
    sr, snippets, batches, cfg = _scan_case(3, 21)
    eps = [np.asarray(e, np.float32) for e in batches[0]]
    graphed = ShardedScanner(snippets, sr, cfg, device=dev)
    eager = ShardedScanner(snippets, sr, cfg, device=dev, graphs=False)
    windows, valid = graphed._windows(eps, 20)
    windows = torch.from_numpy(windows).to(dev)
    valid = torch.from_numpy(valid).to(dev)
    for scale in (True, True, False, True):
        _bitwise(graphed._windows_step(windows, valid, scale),
                 eager._windows_step(windows, valid, scale))
    assert dict(graphed.step_graphs.stats) == {"first": 1, "captures": 1,
                                               "hits": 2}
    got = graphed.scan(eps)
    assert got == eager.scan(eps)
    assert got[0][0]  # the plant, found


@pytest.mark.parametrize("path", ["batch", "match", "spectrogram",
                                  "windows"])
def test_a_refused_capture_raises_on_every_new_path(dev, monkeypatch, path):
    """A capture that fails on one of the paths graphed here raises on
    that call and on the next; neither runs the step eagerly in its
    place."""
    from audio_matcher_tpu_torch.models.spectrogram import (
        SpectrogramConfig, SpectrogramMatcher)

    sr, snippet, eps, cfg = _single_case(22)
    cache = None
    if path == "batch":
        m = SnippetMatcher(snippet, sr, cfg, device=dev)
        staged = m.stage_batch(eps)

        def call():
            return m.match_staged_batch(staged)
    elif path == "match":
        cache = _fresh_call_graphs(monkeypatch)

        def call():
            return port.match(snippet, eps[0], sr, device=dev,
                              chunk_secs=1.0, distance_secs=2.0)
    elif path == "spectrogram":
        sr, snip, episode = _spectrogram_case(23, 120, (40.0,))
        m = SpectrogramMatcher(snip, sr, SpectrogramConfig(
            distance_secs=30.0), device=dev)

        def call():
            return m.match(episode)
    else:
        m = ShardedScanner([snippet], sr, cfg, device=dev)

        def call():
            return m.scan(eps)
    cache = cache or m.step_graphs
    call()  # first sight: eager
    _refusing_graph(monkeypatch)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capturing"):
            call()
    assert dict(cache.stats) == {"first": 1}


def test_a_dropped_cache_lets_the_shared_pool_go(dev, monkeypatch):
    """``match()``'s graph lives on in the shared cache; a kept matcher of
    a larger fft_len (2^23) captures into the same pool and is dropped:
    both graphs go, and the allocator takes the pool's blocks back (a
    pool kept by a live graph would keep them all)."""
    from audio_matcher_tpu_torch.parallel import step_graph

    cache = _fresh_call_graphs(monkeypatch)
    sr, snippet, eps, cfg = _single_case(25)
    kw = dict(chunk_secs=1.0, distance_secs=2.0, transfer_dtype="mulaw8")
    for _ in range(3):
        port.match(snippet, eps[0], sr, device=dev, **kw)
    assert cache.stats["hits"] == 1
    big_cfg = MatchConfig(chunk_secs=600.0, distance_secs=2.0,
                          transfer_dtype="mulaw8")
    long_ep = np.tile(eps[0], 6)
    # the device constants of the larger size (twiddle tables, ...) are
    # built first, so that what the process holds after is the pool's
    SnippetMatcher(snippet, sr, big_cfg, device=dev,
                   graphs=False).match(long_ep)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    small = torch.cuda.memory_reserved(dev)
    big = SnippetMatcher(snippet, sr, big_cfg, device=dev)
    for _ in range(3):
        big.match(long_ep)
    assert big.step_graphs.stats["hits"] == 1
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with_big = torch.cuda.memory_reserved(dev)
    assert with_big > small
    del big
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert not step_graph._DEVICES[torch.device(dev)].graphs
    freed = with_big - torch.cuda.memory_reserved(dev)
    assert freed >= 0.9 * (with_big - small)
    got = port.match(snippet, eps[0], sr, device=dev, **kw)  # captures
    assert got == SnippetMatcher(snippet, sr, MatchConfig(**kw), device=dev,
                                 graphs=False).match(eps[0])
    assert dict(cache.stats) == {"first": 1, "captures": 2, "hits": 1}


def test_graphed_pool_gives_way_to_a_step_that_fits_alone(dev, monkeypatch):
    """A graphed matcher's pool (fft_len 2^24) is held, and the card's limit
    (``set_per_process_memory_fraction``) set so that a matcher at 2^25
    fits only without that pool: its first sight runs out of memory,
    releases the device's graphs and runs once more; then, the limit
    lifted, it captures and replays. Every call's peaks equal the eager
    matcher's. An eviction
    hands the evicted pool back: a small graph's capture in a store full
    with the 2^25 graph lowers the reserved memory by most of that step's
    own."""
    from audio_matcher_tpu_torch.parallel import step_graph

    monkeypatch.setattr(step_graph, "_DEVICES", {})
    sr = 8000
    rng = np.random.default_rng(28)
    snippet = (rng.standard_normal(4000) * 0.2).astype(np.float32)
    episode = (rng.standard_normal(3200 * sr) * 0.05).astype(np.float32)
    for at in (100, 2500):
        episode[at * sr : at * sr + 4000] = snippet
    wire = quantize_wire(episode, "mulaw8")

    def matcher(chunk_secs, graphs=True):
        return SnippetMatcher(snippet, sr, MatchConfig(
            chunk_secs=chunk_secs, distance_secs=60.0,
            transfer_dtype="mulaw8", slab=2, slab_auto=False), device=dev,
            graphs=graphs)

    def reserved():
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(dev)

    small, large, eager = matcher(1500.0), matcher(3000.0), matcher(
        3000.0, graphs=False)
    assert (small.fft_len, large.fft_len) == (1 << 24, 1 << 25)
    large._state = eager._query_state  # one spectrum for both
    staged = eager.stage(wire)
    want = eager.match_staged(staged)  # the size's plans and constants
    base = reserved()
    torch.cuda.reset_peak_memory_stats(dev)
    assert eager.match_staged(staged) == want
    need = torch.cuda.max_memory_reserved(dev) - base  # the step's own
    assert sorted(p.position for p in want if p.height > 0.5) == [
        100 * sr, 2500 * sr]
    staged_small = small.stage(wire)
    small.match_staged(staged_small)  # first sight
    before = reserved()
    small.match_staged(staged_small)  # capture
    held = reserved()
    pool = held - before
    assert pool > 0
    total = torch.cuda.get_device_properties(dev).total_memory
    torch.cuda.set_per_process_memory_fraction(
        (held + need - pool // 2) / total, dev)
    try:
        got = [large.match_staged(staged)]  # first sight
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
    got += [large.match_staged(staged) for _ in range(2)]  # capture, replay
    assert all(g == want for g in got)
    assert dict(large.step_graphs.stats) == {
        "first": 1, "released": 1, "captures": 1, "hits": 1}
    store = step_graph._DEVICES[torch.device(dev)]
    assert store.released == 1
    assert [k[0] for k in store.graphs] == [large.step_graphs._token]
    assert [k[0] for k in store.seen].count(small.step_graphs._token) == 1

    monkeypatch.setattr(step_graph, "GRAPHS_PER_DEVICE", 1)
    tiny = matcher(10.0)
    staged_tiny = tiny.stage(wire)
    tiny.match_staged(staged_tiny)  # first sight
    with_large = reserved()
    got = tiny.match_staged(staged_tiny)  # capture: the 2^25 graph goes
    assert tiny.step_graphs.stats["evicted"] == 1
    assert with_large - reserved() >= need // 2
    assert sorted(p.position for p in got if p.height > 0.5) == [
        100 * sr, 2500 * sr]


def test_match_from_two_threads_returns_each_snippets_peaks(dev,
                                                            monkeypatch):
    """Two threads call ``match()`` at once with two snippets of one length
    (one graph of the shared cache): every call returns its own snippet's
    peaks, those of the eager matcher."""
    import threading

    cache = _fresh_call_graphs(monkeypatch)
    sr, snippet, eps, cfg = _single_case(26)
    other = (np.random.default_rng(27).standard_normal(4000) * 0.2).astype(
        np.float32)
    ep = eps[0].copy()
    ep[int(14.0 * sr) : int(14.0 * sr) + 4000] = other
    kw = dict(chunk_secs=1.0, distance_secs=2.0, transfer_dtype="mulaw8")
    want = {id(s): SnippetMatcher(s, sr, MatchConfig(**kw), device=dev,
                                  graphs=False).match(ep)
            for s in (snippet, other)}
    for _ in range(2):
        port.match(snippet, ep, sr, device=dev, **kw)  # first, capture
    start = threading.Barrier(2)
    wrong = []

    def calls(snip):
        start.wait()
        for _ in range(10):
            got = port.match(snip, ep, sr, device=dev, **kw)
            if got != want[id(snip)]:
                wrong.append(got)

    threads = [threading.Thread(target=calls, args=(s,))
               for s in (snippet, other)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not wrong
    assert dict(cache.stats) == {"first": 1, "captures": 1, "hits": 20}


def test_spans_of_a_replayed_group_stay_off_the_device_timeline(dev):
    """The port's spans (``utils/spans.py``) under a CUDA profiler: a sweep
    group's shape is seen and captured before the profiler starts, and one
    more group, replayed under it, records each boundary once with the
    group's number, the replay's copy-in, launch and copy-out, while the
    upload's ``Memcpy HtoD`` lies on the device's timeline, over 0 ms; no
    event there is named ``audio_matcher.*``."""
    from torch.profiler import ProfilerActivity, profile

    from audio_matcher_tpu_torch.utils import spans

    sr, snippets, batches, cfg = _scan_case(3, 21)
    sc = ShardedScanner(snippets, sr, cfg, device=dev)
    for _ in range(2):  # first sight, capture
        sc.scan_collect(sc.scan_dispatch(sc.stage_resident(batches[0])))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = sc.scan_collect(sc.scan_dispatch(sc.stage_resident(
            batches[1])))
        torch.cuda.synchronize(dev)
    assert got[0][0]  # the plant, found
    assert dict(sc.step_graphs.stats) == {"first": 1, "captures": 1,
                                          "hits": 1}
    recs = spans.records()
    host = [r.name for r in recs]
    for name in ("stage", "stage.alloc", "stage.fill", "stage.upload",
                 "dispatch", "dispatch.lengths", "graph.copy_in",
                 "graph.launch", "graph.copy_out", "collect", "collect.wait",
                 "collect.peaks"):
        assert host.count(name) == 1, name
    assert not {"graph.first", "graph.capture"} & set(host)
    assert {r.group for r in recs} == {2}
    on_device = [ev for ev in prof.profiler.kineto_results.events()
                 if ev.device_type() == torch.autograd.DeviceType.CUDA]
    assert max(ev.duration_ns() for ev in on_device
               if ev.name().startswith("Memcpy HtoD")) > 0
    assert not [ev for ev in on_device
                if ev.name().startswith(spans.PREFIX)]


def test_a_traced_part_wise_stage_keeps_one_upload_and_one_fill(
        dev, small_parts):
    """Under a profiler, a stage copied in parts records one
    ``stage.upload`` around one ``stage.fill`` and a ``stage.fill.part``
    a range of the plan. (The CPU's activity alone: the device timeline
    of a staged group is ``test_spans_of_a_replayed_group_stay_off_the_
    device_timeline``'s.)"""
    from torch.profiler import ProfilerActivity, profile

    from audio_matcher_tpu_torch.utils import spans

    matcher = small_parts
    width = 400_000
    eps = [np.ones(width, np.float32)]
    plan = matcher.fill_plan(1, width, 4)
    matcher.stage_rows_host(eps, [width], width, "float32", 1, dev)
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("stage", 7):
            staged = matcher.stage_rows_host(eps, [width], width,
                                             "float32", 1, dev)[0]
    assert torch.equal(staged.cpu(), torch.ones(1, width))
    recs = spans.records()
    names = [r.name for r in recs]
    assert names.count("stage.upload") == names.count("stage.fill") == 1
    assert names.count("stage.fill.part") == len(plan) > 1
    (upload,) = [r for r in recs if r.name == "stage.upload"]
    (fill,) = [r for r in recs if r.name == "stage.fill"]
    assert upload.t0_ns <= fill.t0_ns <= fill.t1_ns <= upload.t1_ns
    assert {r.group for r in recs} == {7}
