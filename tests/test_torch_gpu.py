"""The port's CUDA kernels against their plain versions, on a GPU.

Marked ``gpu``: these need a CUDA device and nvcc, and skip without them
(a CUDA kernel has no CPU mode). Run them on a GPU machine with

    python -m pytest tests/test_torch_gpu.py -m gpu

FFT passes agree with their plain versions (cuFFT) within 1e-5 of the
largest plain value (measured about 3e-7); the block reduction and the
peak picks are exact. Every ``fft_impl`` × ``peaks_impl`` runs on the card
against ``plain=True``.
"""

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


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.float32])
def test_fft_passes_match_plain(dev, n, dtype):
    g = torch.Generator(device=dev).manual_seed(n)
    A, M = F.split_factors(n)
    W, chunk, B = int(n * 0.77), int(n * 0.6), 3
    Qh = 4 if n <= 1 << 22 else 2
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
    n = 1 << 25  # M = 8192 does not fit the minor pass's tile
    A, M = F.split_factors(n)
    x = torch.zeros((1, A, M), device=dev)
    for call in (lambda: F.fft_minor(x, x, M),
                 lambda: F.ifft_minor(x, x, M),
                 lambda: F.fft_major_forward(x, x, A, n),
                 lambda: F.fft_major_fwd_wire(
                     torch.zeros((1, n), device=dev), A, n, n)):
        with pytest.raises(ValueError, match="4096"):
            call()
    snippet = np.zeros(80000, np.float32)
    snippet[::7] = 0.1
    with pytest.raises(ValueError, match="2\\^24"):
        SnippetMatcher(snippet, 8000, MatchConfig(chunk_secs=2200.0),
                       device=dev)


@pytest.mark.parametrize("n", SIZES)
def test_new_modes_match_plain(dev, n):
    """The inverse minor pass and the forward major pass of complex
    planes, and the fft2_scrambled round trip (n·x)."""
    g = torch.Generator(device=dev).manual_seed(n + 1)
    A, M = F.split_factors(n)
    P = 4 if n <= 1 << 22 else 2
    xr = torch.randn(P, A, M, device=dev, generator=g)
    xi = torch.randn(P, A, M, device=dev, generator=g)
    _close(F.fft_major_forward(xr, xi, A, n),
           F.fft_major_forward_plain(xr, xi, A, n))
    _close(F.ifft_minor(xr, xi, M), F.ifft_minor_plain(xr, xi, M))
    X = F.fft2_scrambled(xr.view(P, n), xi.view(P, n), n)
    _close(X, F.fft2_scrambled(xr.view(P, n), xi.view(P, n), n, plain=True))
    back = F.fft2_scrambled(X[0], X[1], n, inverse=True)
    _close(back, (xr.view(P, n) * n, xi.view(P, n) * n))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("P", [1, 3])
def test_passes_at_one_and_odd_planes_every_crop_and_twice(dev, n, P):
    """Every mode at P = 1 and an odd P, the inverse major pass at a_crop
    1, A/2 + 8 and A; a second launch of each is bitwise equal to the
    first (no order-dependent arithmetic)."""
    g = torch.Generator(device=dev).manual_seed(n + P)
    A, M = F.split_factors(n)
    xr = torch.randn(P, A, M, device=dev, generator=g)
    xi = torch.randn(P, A, M, device=dev, generator=g)
    tr = torch.randn(2, A, M, device=dev, generator=g)
    ti = torch.randn(2, A, M, device=dev, generator=g)
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
        _close(got, plain())


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


@pytest.mark.parametrize("n", [1 << 14, 1 << 21, 1 << 22, 1 << 23, 1 << 24])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.float32])
@pytest.mark.parametrize("B", [4, 5])
def test_major_fwd_wire2_matches_plain(dev, n, dtype, B):
    """Kernel 6 on strided even/odd windows of one episode; odd B pairs
    the last window with wire silence."""
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


def _offset_windows(ep, off, rows, W, chunk):
    """[rows, W] windows of ``ep`` ``chunk`` apart, starting ``off``
    elements in: row starts at every alignment."""
    return ep[off:].as_strided((rows, W), (chunk, 1))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.float32])
def test_wire_passes_at_every_row_alignment_match_plain(dev, n, dtype):
    """Kernels 1 and 6 on 3 windows (odd P) whose starts sit 0-15 bytes off
    a 16-byte boundary, an odd chunk apart; kernel 6 with 1 and 3 odd
    windows."""
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


@pytest.mark.parametrize("n", SIZES)
def test_wire_passes_at_strip_and_row_edges_match_plain(dev, n):
    """w_len on a row edge (a * M), on a strip edge (+ C), one short of
    it, and 5 samples: the points past it read as zero."""
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
