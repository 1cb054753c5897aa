"""The port's FFT passes against the JAX package's Pallas kernels.

Each pass's plain PyTorch version (what the wrapper runs on a CPU tensor)
is held against the JAX pass in Pallas interpret mode, on the same numpy
inputs, in the same scrambled layout, array for array. Tolerance: 3e-6 of
the largest reference value (the JAX package's own FFT oracle bound,
tests/test_pallas_fft.py); the JAX kernels run a DFT-128 matmul stage and
the port's plain versions ``torch.fft``, which agree to about 5e-7.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from audio_matcher_tpu.ops import pallas_fft as J  # noqa: E402

from audio_matcher_tpu_torch.models.matcher import quantize_wire  # noqa: E402
from audio_matcher_tpu_torch.ops import cuda_fft as T  # noqa: E402

TOL = 3e-6
SIZES = [1 << 14, 1 << 15]


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want):
    for plane, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), _np(w)
        assert g.shape == w.shape
        ratio = np.max(np.abs(g - w)) / np.max(np.abs(w))
        assert ratio < TOL, (
            f"plane {plane}: max |port - jax| / max |jax| = {ratio:.3e} "
            f"(tol {TOL:g}; max |jax| {np.max(np.abs(w)):.3e}, finite: "
            f"port {np.isfinite(g).all()}, jax {np.isfinite(w).all()})")


def _wire(rng, shape, wire):
    x = np.clip(rng.standard_normal(shape) * 0.15, -0.45, 0.45)
    return quantize_wire(x.astype(np.float32), wire)


def _spectrum(rng, n, B=3):
    A, M = J.split_factors(n)
    xr = rng.standard_normal((B, A, M)).astype(np.float32)
    xi = rng.standard_normal((B, A, M)).astype(np.float32)
    return xr, xi


def test_factor_helpers_match():
    for n in SIZES + [1 << 22]:
        assert T.split_factors(n) == J.split_factors(n)
        np.testing.assert_array_equal(T.scramble_index(n), J.scramble_index(n))
        for w in (1, 8000, n // 3, n):
            assert T.round_planes_width(w, n) == J.round_planes_width(w, n)
    for L in (128, 2048):
        np.testing.assert_array_equal(T._brev_host(L), J._brev_host(L))
    with pytest.raises(ValueError):
        T.split_factors(3 << 14)
    with pytest.raises(ValueError):
        T.split_factors(1 << 13)
    assert T.MIN_N == J.MIN_N


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("wire", ["mulaw8", "int16"])
def test_major_fwd_wire_matches(n, wire):
    rng = np.random.default_rng(n + len(wire))
    A, M = J.split_factors(n)
    w_len = int(n * 0.72)  # the zero-pad tail is masked in the pass
    win = _wire(rng, (3, n), wire)
    want = J.fft_major_fwd_wire(
        jnp.asarray(win).reshape(3, A, M), A, n, w_len, interpret=True
    )
    got = T.fft_major_fwd_wire(_t(win[:, :w_len]), A, n, w_len)
    _close(got, want)
    # a row longer than w_len: the tail is masked, not read
    _close(T.fft_major_fwd_wire(_t(win), A, n, w_len), want)


def test_major_fwd_wire_strided_windows(rng):
    """Overlap-save windows as a strided view of one episode."""
    n = SIZES[0]
    A, M = J.split_factors(n)
    chunk, W = 9000, 12002
    ep = _wire(rng, 3 * chunk + W, "mulaw8")
    rows = np.stack([ep[b * chunk : b * chunk + W] for b in range(4)])
    view = _t(ep).as_strided((4, W), (chunk, 1))
    want = J.fft_major_fwd_wire(
        jnp.asarray(np.pad(rows, ((0, 0), (0, n - W)))).reshape(4, A, M),
        A, n, W, interpret=True,
    )
    _close(T.fft_major_fwd_wire(view, A, n, W), want)


@pytest.mark.parametrize("n", SIZES)
def test_minor_matches(n, rng):
    A, M = J.split_factors(n)
    xr, xi = _spectrum(rng, n)
    want = J.fft_minor(jnp.asarray(xr), jnp.asarray(xi), M, interpret=True)
    _close(T.fft_minor(_t(xr), _t(xi), M), want)
    # into preallocated planes, as the slab runs it
    planes = (torch.empty(xr.shape), torch.empty(xr.shape))
    got = T.fft_minor(_t(xr), _t(xi), M, out=planes)
    assert got[0] is planes[0]
    _close(got, want)


@pytest.mark.parametrize("n", SIZES)
def test_scrambled_query_spectra_odd_q(n, rng):
    snippets = (rng.standard_normal((3, 3000)) * 0.2).astype(np.float32)
    for pack in (True, False):
        want = J.scrambled_query_spectra(snippets, n, pack)
        got = T.scrambled_query_spectra(_t(snippets), n, pack)
        assert got[0].shape == (2 if pack else 3, n)
        _close(got, want)


@pytest.mark.parametrize("n", SIZES)
def test_minor_product_matches(n, rng):
    A, M = J.split_factors(n)
    xr, xi = _spectrum(rng, n)
    snippets = (rng.standard_normal((3, 2000)) * 0.2).astype(np.float32)
    tr, ti = (_np(t).reshape(-1, A, M)
              for t in J.scrambled_query_spectra(snippets, n, True))
    want = J.ifft_minor_product(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(tr), jnp.asarray(ti),
        M, interpret=True,
    )
    got = T.ifft_minor_product(_t(xr), _t(xi), _t(tr), _t(ti), M)
    assert got[0].shape == (3 * 2, A, M)
    _close(got, want)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("crop", ["full", "cropped"])
def test_major_inverse_matches(n, crop, rng):
    A, M = J.split_factors(n)
    a_crop = A if crop == "full" else A // 2 + 8
    xr, xi = _spectrum(rng, n, B=4)
    want = J.fft_major(
        jnp.asarray(xr), jnp.asarray(xi), A, n, inverse=True,
        interpret=True, a_crop=a_crop,
    )
    got = T.fft_major(_t(xr), _t(xi), A, n, a_crop)
    assert got[0].shape == (4, a_crop, M)
    _close(got, want)
    with pytest.raises(ValueError):
        T.fft_major(_t(xr), _t(xi), A, n, A + 1)


@pytest.mark.parametrize("wire", ["mulaw8", "int16"])
def test_corr_slab_planes_wire_matches(wire, rng):
    """The whole slab: four passes from wire windows to cropped planes."""
    n = SIZES[0]
    A, M = J.split_factors(n)
    W = 12002
    win = _wire(rng, (5, W), wire)
    snippets = (rng.standard_normal((3, 4000)) * 0.2).astype(np.float32)
    tr, ti = J.scrambled_query_spectra(snippets, n, True)
    width = 8 * M
    want = J.corr_slab_vpu_planes_wire(
        jnp.asarray(win), tr, ti, width, interpret=True
    )
    got = T.corr_slab_vpu_planes_wire(_t(win), _t(tr), _t(ti), width)
    assert got[0].shape == (5 * 2, width)
    _close(got, want)
    # plain=True and preallocated work planes give the same planes
    work = {}
    again = T.corr_slab_vpu_planes_wire(
        _t(win), _t(tr), _t(ti), width, plain=True, work=work
    )
    assert set(work) == {"x", "x2", "v", "y"}
    _close(again, want)
    with pytest.raises(ValueError):
        T.corr_slab_vpu_planes_wire(_t(win), _t(tr), _t(ti), width + M)


def test_wrappers_dispatch_by_device(rng):
    """CPU tensors take the plain version (no launch is counted); a device
    with neither a kernel nor a plain version is refused."""
    n = SIZES[0]
    A, M = J.split_factors(n)
    before = [k.launches for k in T.KERNELS]
    xr, xi = _spectrum(rng, n, B=1)
    T.fft_minor(_t(xr), _t(xi), M)
    assert [k.launches for k in T.KERNELS] == before
    meta = torch.empty((1, A, M), device="meta")
    with pytest.raises(ValueError):
        T.fft_minor(meta, meta, M)
    with pytest.raises(ValueError):
        T.fft_minor(_t(xr), meta, M)


@pytest.mark.parametrize("wire", ["mulaw8", "int16", "float32"])
def test_major_fwd_wire2_matches(wire, rng):
    """Kernel 6's plain version against the Pallas pair pass: w_len < n,
    an odd window count (the last pair's odd member is wire silence) and
    strided views of one episode, as the single-query slab reads them."""
    n = SIZES[0]
    A, M = J.split_factors(n)
    chunk, W, B = 5000, 12002, 5
    ep = _wire(rng, (B - 1) * chunk + W, wire)
    rows = np.stack([ep[b * chunk : b * chunk + W] for b in range(B)])
    fill = 128 if wire == "mulaw8" else 0
    padded = np.pad(rows, ((0, 1), (0, n - W)), constant_values=0)
    padded[B, :] = fill
    padded[B, W:] = 0  # masked past w_len in the kernel either way
    P = (B + 1) // 2
    want = J.fft_major_fwd_wire2(
        jnp.asarray(padded[0::2]).reshape(P, A, M),
        jnp.asarray(padded[1::2]).reshape(P, A, M),
        A, n, W, interpret=True,
    )
    view = _t(ep).as_strided((B, W), (chunk, 1))
    got = T.fft_major_fwd_wire2(view[0::2], view[1::2], A, n, W)
    assert got[0].shape == (P, A, M)
    _close(got, want)
    # an even count: every pair is real
    want = J.fft_major_fwd_wire2(
        jnp.asarray(padded[0:4:2]).reshape(2, A, M),
        jnp.asarray(padded[1:4:2]).reshape(2, A, M),
        A, n, W, interpret=True,
    )
    _close(T.fft_major_fwd_wire2(view[0:4:2], view[1:4:2], A, n, W), want)


def test_scrambled_single_query_spectra_pack_forms_agree(rng):
    """At Q = 1 the query-pair spectra (pack=True) are the single-query
    ones (pack=False): the pad query's spectrum is zero, so the scanner's
    Q = 1 branch reads the pair form as the single-query kernel's."""
    snippet = (rng.standard_normal((1, 3000)) * 0.2).astype(np.float32)
    packed = T.scrambled_query_spectra(_t(snippet), SIZES[0], True)
    single = T.scrambled_query_spectra(_t(snippet), SIZES[0], False)
    for a, b in zip(packed, single):
        assert torch.equal(a, b)


@pytest.mark.parametrize("wire", ["mulaw8", "int16"])
@pytest.mark.parametrize("B", [4, 5])
def test_corr_single_query_planes_wire_matches(wire, B, rng):
    """The single-query slab: pair pass → minor → product at Qh = 1 →
    cropped inverse major, from wire windows to planes."""
    n = SIZES[0]
    A, M = J.split_factors(n)
    W = 12002
    win = _wire(rng, (B, W), wire)
    snippet = (rng.standard_normal((1, 4000)) * 0.2).astype(np.float32)
    s_r, s_i = J.scrambled_query_spectra(snippet, n, False)
    width = 8 * M
    want = J.corr_single_query_vpu_planes_wire(
        jnp.asarray(win), s_r, s_i, width, interpret=True
    )
    got = T.corr_single_query_vpu_planes_wire(
        _t(win), _t(s_r), _t(s_i), width
    )
    # for odd B the last yi row correlates the silence pad on both sides
    assert got[0].shape == ((B + 1) // 2, width)
    _close(got, want)
    work = {}
    again = T.corr_single_query_vpu_planes_wire(
        _t(win), _t(s_r), _t(s_i), width, plain=True, work=work
    )
    assert set(work) == {"x", "x2", "v", "y"}
    assert torch.equal(again[0], got[0])
    with pytest.raises(ValueError):
        T.corr_single_query_vpu_planes_wire(
            _t(win), _t(s_r), _t(s_i), width + M
        )


TOL_VPU = 1e-5  # the f32-window slabs: three FFT passes each way


def _close_to(got, want, tol):
    for g, w in zip(got, want):
        g, w = g.numpy(), _np(w)
        assert g.shape == w.shape
        assert np.max(np.abs(g - w)) / np.max(np.abs(w)) < tol


@pytest.mark.parametrize("n", SIZES)
def test_fft2_scrambled_matches(n, rng):
    """Both directions against the JAX transform (the forward major pass
    of complex planes and the inverse minor pass are this slice's modes),
    with and without work planes; the round trip gives n·x."""
    xr = rng.standard_normal((3, n)).astype(np.float32)
    xi = rng.standard_normal((3, n)).astype(np.float32)
    want = J.fft2_scrambled(jnp.asarray(xr), jnp.asarray(xi), n,
                            interpret=True)
    got = T.fft2_scrambled(_t(xr), _t(xi), n)
    _close_to(got, want, TOL_VPU)
    # natural→scrambled: the layout contract against numpy
    ref = np.fft.fft(xr.astype(np.float64) + 1j * xi)[:, T.scramble_index(n)]
    _close_to(got, (ref.real, ref.imag), TOL_VPU)
    back = T.fft2_scrambled(got[0], got[1], n, inverse=True, work={})
    _close_to(back, J.fft2_scrambled(
        jnp.asarray(got[0].numpy()), jnp.asarray(got[1].numpy()), n,
        inverse=True, interpret=True,
    ), TOL_VPU)
    _close_to(back, (n * xr, n * xi), TOL_VPU)
    A, M = T.split_factors(n)
    planes = [torch.from_numpy(p).view(3, A, M) for p in (xr, xi)]
    _close_to(T.fft_major_forward(*planes, A, n),
              J.fft_major(jnp.asarray(xr).reshape(3, A, M),
                          jnp.asarray(xi).reshape(3, A, M), A, n,
                          interpret=True), TOL)
    _close_to(T.ifft_minor(*planes, M),
              J.fft_minor(jnp.asarray(xr).reshape(3, A, M),
                          jnp.asarray(xi).reshape(3, A, M), M, inverse=True,
                          interpret=True), TOL)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("B", [5, 4])
def test_corr_slab_vpu_matches(n, B, rng):
    """The multi-query slab from f32 windows, an odd query count (Q = 3:
    the pad query's pair) and odd and even window counts."""
    W, valid = int(n * 0.7), int(n * 0.45)
    win = (rng.standard_normal((B, W)) * 0.1).astype(np.float32)
    snippets = (rng.standard_normal((3, 3000)) * 0.2).astype(np.float32)
    tr, ti = J.scrambled_query_spectra(snippets, n, True)
    want = J.corr_slab_vpu(jnp.asarray(win), tr, ti, valid, interpret=True)
    got = T.corr_slab_vpu(_t(win), _t(tr), _t(ti), valid)
    assert got.shape == (B, 4, valid)
    _close_to([got], [want], TOL_VPU)
    _, M = T.split_factors(n)
    want = J.corr_slab_vpu_planes(jnp.asarray(win), tr, ti, 8 * M,
                                  interpret=True)
    work = {}
    got = T.corr_slab_vpu_planes(_t(win), _t(tr), _t(ti), 8 * M, work=work)
    _close_to(got, want, TOL_VPU)
    assert {"w", "x", "x2", "v", "y"} <= set(work)
    again = T.corr_slab_vpu_planes(_t(win), _t(tr), _t(ti), 8 * M,
                                   plain=True, work=work)
    assert torch.equal(again[0], got[0])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("B", [5, 4])
def test_corr_single_query_vpu_matches(n, B, rng):
    """The single-query slab from f32 windows: window pairs, the odd-B
    pad window zero."""
    W, valid = int(n * 0.7), int(n * 0.45)
    win = (rng.standard_normal((B, W)) * 0.1).astype(np.float32)
    snippet = (rng.standard_normal((1, 3000)) * 0.2).astype(np.float32)
    s_r, s_i = J.scrambled_query_spectra(snippet, n, False)
    want = J.corr_single_query_vpu(jnp.asarray(win), s_r, s_i, valid,
                                   interpret=True)
    got = T.corr_single_query_vpu(_t(win), _t(s_r), _t(s_i), valid,
                                  work={})
    assert got.shape == (B, valid)
    _close_to([got], [want], TOL_VPU)
    ref = np.correlate(win[1].astype(np.float64), snippet[0], "valid")
    np.testing.assert_allclose(  # the valid lags are the linear correlation
        got[1].numpy(), ref[:valid], atol=2e-5 * np.abs(ref).max()
    )
    _, M = T.split_factors(n)
    want = J.corr_single_query_vpu_planes(jnp.asarray(win), s_r, s_i, 8 * M,
                                          interpret=True)
    got = T.corr_single_query_vpu_planes(_t(win), _t(s_r), _t(s_i), 8 * M)
    assert got[0].shape == ((B + 1) // 2, 8 * M)
    # an odd B's last imaginary row correlates the zero pad window
    rows = B // 2
    _close_to([got[0], got[1][:rows]], [want[0], _np(want[1])[:rows]],
              TOL_VPU)
