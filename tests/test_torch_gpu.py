"""The port's CUDA kernels against their plain versions, on a GPU.

Marked ``gpu``: these need a CUDA device and nvcc, and skip without them
(a CUDA kernel has no CPU mode). Run them on a GPU machine with

    python -m pytest tests/test_torch_gpu.py -m gpu

FFT passes agree with their plain versions (cuFFT) within 1e-5 of the
largest plain value (measured about 3e-7); the block reduction and the
peak picks are exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from audio_matcher_tpu_torch.models.matcher import (  # noqa: E402
    MatchConfig,
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


# A = M (2^14, 2^22) and M = 2A (2^15, 2^21)
@pytest.mark.parametrize("n", [1 << 14, 1 << 15, 1 << 21, 1 << 22])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.float32])
def test_fft_passes_match_plain(dev, n, dtype):
    g = torch.Generator(device=dev).manual_seed(n)
    A, M = F.split_factors(n)
    W, chunk, B, Qh = int(n * 0.77), int(n * 0.6), 3, 4
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
    n = 1 << 23  # M = 4096 does not fit the minor pass's tile
    A, M = F.split_factors(n)
    x = torch.zeros((1, A, M), device=dev)
    with pytest.raises(ValueError):
        F.fft_minor(x, x, M)
    with pytest.raises(ValueError):
        F.fft_major_fwd_wire(torch.zeros((1, n), device=dev), A * 4, n, n)


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
    before = [k.launches for k in F.KERNELS + K.KERNELS]
    got = scanner.scan_dispatch(staged)
    after = [k.launches for k in F.KERNELS + K.KERNELS]
    assert all(a > b for a, b in zip(after, before))
    want = plain.scan_dispatch(staged)
    assert [k.launches for k in F.KERNELS + K.KERNELS] == after
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
