// The two-factor scrambled FFT passes of the scans, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of audio_matcher_tpu/ops/pallas_fft.py:
//   major_pass<In, false>       <- fft_major_fwd_wire (_major_fwd_wire_kernel)
//   major_pass<In, false, true> <- fft_major_fwd_wire2 (_major_fwd_wire2_kernel)
//   major_pass<float, false, true> on f32 planes
//                               <- fft_major(inverse=False, cross=True)
//   major_pass<float, true>     <- fft_major(inverse=True, cross=True, a_crop)
//   minor_pass<MINOR_FORWARD>   <- fft_minor (forward)
//   minor_pass<MINOR_INVERSE>   <- fft_minor (inverse)
//   minor_pass<MINOR_PRODUCT>   <- ifft_minor_product (_minor_product_kernel)
//
// The pair mode is the single-query path: two wire windows go in as
// fft(w0 + i*w1), both decoded in-register. The windows are strided views
// of the staged episode (even and odd windows at twice the hop), read by
// pointer and stride; the pad window of an odd slab is never materialized:
// rows past the odd windows' count read wire silence instead. At one query
// the slab is small: at config #2 (8 windows, A = M = 2048) the pair pass
// reads 8 x 3.1 MB of mu-law and writes 2 x 4 x 16 MB of planes, in M/8 = 256
// strips per pair, 1024 blocks, about 8 waves of one block per SM. The same
// pair instantiation with f32 "wire" rows of stride n and w_len = n is the
// forward major pass of fft2_scrambled: a complex f32 [P, A, M] input.
//
// What is computed. A transform of length n = A*M is viewed as [A, M],
// a-major. The forward major pass runs a radix-2 DIF over the strided A axis
// of every column c (natural input, bit-reversed output) and then multiplies
// physical row r by the cross twiddle W_n^{brev_A(r)*c}. The forward minor
// pass runs the same DIF along each contiguous M row. Together they leave the
// scrambled spectrum Y[r, q] = X[brev_A(r) + A*brev_M(q)]; nothing here ever
// reorders it. The inverse passes undo the stages in reverse order with
// conjugate twiddles (bit-reversed input, natural output, unscaled; the 1/n
// is folded into the query spectra by the caller).
//
// What bounds it on an H100. Every pass is a streaming pass over f32 planes,
// so it is bound by device-memory bytes: at the batch scan's slab
// (B=8 windows, Qh=32 query pairs, A=M=2048) the product pass writes
// 2 x 4.3 GB and the inverse major pass reads them back and writes 2 x 2.9 GB.
// Shared memory is the second limit: a block may hold at most 227 KB, so the
// major pass cannot keep a [2048, 512] complex tile resident as the TPU does
// in VMEM. It takes a strip of 8 columns (2048 x 8 complex = 128 KB), reads
// each row of the strip as one 32-byte sector, and keeps the block count high
// instead (one block per SM at this size). At A = 4096 (fft_len 2^24) the
// strip narrows to 4 columns (4096 x 4 complex = 128 KB), a template
// parameter chosen at launch; the minor pass holds a whole M-row (3*M floats
// with its twiddles: 48 KB at M = 4096) and, in the product mode, 16 instead
// of 8 elements per thread in registers at M = 4096.
//
// What the design does about it. The product pass multiplies the window
// spectrum by each query pair's spectrum in registers and transforms it in
// shared memory, so the [B*Qh, n] product planes are never written; each
// window row is read once and stays in registers across all Qh queries, and
// blocks of the same row index are adjacent in the grid so the query rows
// they share are served from L2. The inverse major pass writes only the
// first a_crop natural-order rows. Twiddles come from a per-block table of
// W_L^k built with sincospif from exact rational arguments (the integer
// exponent brev(r)*c is formed exactly before any float scale, as the TPU
// kernel does); there is no fast-math and no tensor-core arithmetic, so all
// butterflies run in full FP32. Offsets into the planes are 64-bit: one
// plane of the product output holds 2^30 elements.
//
// Each C entry point returns cudaGetLastError() of its launch, or
// cudaErrorInvalidValue for a factor it has no tile for.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAJOR_THREADS = 512;
constexpr int MINOR_THREADS = 256;
constexpr int MAX_LOG2_FACTOR = 12;  // A, M <= 4096: n <= 2^24

enum MinorMode { MINOR_FORWARD, MINOR_INVERSE, MINOR_PRODUCT };

__device__ __forceinline__ int brev_bits(int x, int bits) {
    return (int)(__brev((unsigned)x) >> (32 - bits));
}

// Wire -> f32 reference-scale PCM, the grid of ops/wire.py: int16 is v/65535;
// mu-law (mu = 255) expands with exp()-1 through an int hop. __fmul_rn and
// __fsub_rn keep the products from being contracted into FMAs.
__device__ __forceinline__ float dequant(uint8_t v) {
    float b = __fsub_rn(__fmul_rn((float)(int)v, (float)(1.0 / 127.5)), 1.0f);
    float mag = __fsub_rn(
        expf(__fmul_rn(fabsf(b), (float)5.545177444479562)), 1.0f);
    float u = __fmul_rn(b >= 0.0f ? mag : -mag, (float)(1.0 / 255.0));
    return __fmul_rn(u, (float)(32768.0 / 65535.0));
}
__device__ __forceinline__ float dequant(int16_t v) {
    return __fmul_rn((float)v, (float)(1.0 / 65535.0));
}
__device__ __forceinline__ float dequant(float v) { return v; }

// tw[k] = exp(-2*pi*i*k/L) for k < L/2 (the forward DIF twiddles).
__device__ __forceinline__ void build_twiddles(float* tw_r, float* tw_i,
                                               int log2L) {
    const int half = 1 << (log2L - 1);
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
        float s, c;
        sincospif(-ldexpf((float)k, 1 - log2L), &s, &c);
        tw_r[k] = c;
        tw_i[k] = s;
    }
}

// exp(sign * 2*pi*i*k/n) for the cross twiddle; k < n <= 2^24 is exact in f32.
__device__ __forceinline__ void cross_twiddle(int k, int log2n, float sign,
                                              float* c, float* s) {
    sincospif(sign * ldexpf((float)k, 1 - log2n), s, c);
}

// Radix-2 DIF stages over the row axis of a [L, C] shared-memory tile
// (element (i, c) at i*C + c). FORWARD: natural in, bit-reversed out.
// Inverse: bit-reversed in, natural out, conjugate twiddles, stages reversed.
template <bool FORWARD>
__device__ __forceinline__ void dif_stages(float* sr, float* si,
                                           const float* tw_r,
                                           const float* tw_i, int log2L,
                                           int log2C) {
    const int n_bfly = 1 << (log2L - 1 + log2C);
    const int C = 1 << log2C;
    for (int s = 0; s < log2L; ++s) {
        // forward: half-size m = L/2 .. 1; inverse: m = 1 .. L/2
        const int log2m = FORWARD ? (log2L - 1 - s) : s;
        const int m = 1 << log2m;
        const int tshift = log2L - 1 - log2m;  // W_{2m}^j = W_L^{j << tshift}
        for (int e = threadIdx.x; e < n_bfly; e += blockDim.x) {
            const int c = e & (C - 1);
            const int jj = e >> log2C;
            const int j = jj & (m - 1);
            const int g = jj >> log2m;
            const int i0 = (((g << (log2m + 1)) + j) << log2C) + c;
            const int i1 = i0 + (m << log2C);
            const float wr = tw_r[j << tshift];
            const float wi = FORWARD ? tw_i[j << tshift] : -tw_i[j << tshift];
            const float ar = sr[i0], ai = si[i0];
            const float br = sr[i1], bi = si[i1];
            if (FORWARD) {
                const float dr = ar - br, di = ai - bi;
                sr[i0] = ar + br;
                si[i0] = ai + bi;
                sr[i1] = dr * wr - di * wi;
                si[i1] = dr * wi + di * wr;
            } else {
                const float bwr = br * wr - bi * wi;
                const float bwi = br * wi + bi * wr;
                sr[i0] = ar + bwr;
                si[i0] = ai + bwi;
                sr[i1] = ar - bwr;
                si[i1] = ai - bwi;
            }
        }
        __syncthreads();
    }
}

// The wire code of silence: mu-law's zero is code 128, the others' is 0.
template <typename In>
__device__ __forceinline__ In wire_silence() { return In(0); }
template <>
__device__ __forceinline__ uint8_t wire_silence<uint8_t>() { return 128; }

// One block per (batch p, strip of 2^LOG2C columns).
// Forward (INVERSE = false): x is the real wire-dtype input, row p at
// x + p*in_stride, element (a, c) at a*M + c, read only below w_len (zero past
// it); output [P, A, M] planes. PAIR: the imaginary plane is read the same
// way from x1 + p*x1_stride for p < x1_rows; rows p >= x1_rows pair with
// wire silence (the pad window of an odd slab), decoded like any sample.
// Inverse: x, xi are [P, A, M] f32 planes; output [P, a_crop, M].
template <typename In, bool INVERSE, bool PAIR, int LOG2C>
__global__ void __launch_bounds__(MAJOR_THREADS)
major_pass(const In* __restrict__ x, const float* __restrict__ xi,
           long long in_stride, const In* __restrict__ x1,
           long long x1_stride, int x1_rows, float* __restrict__ yr,
           float* __restrict__ yi, int log2A, int log2M, long long w_len,
           int a_crop) {
    extern __shared__ float smem[];
    constexpr int C = 1 << LOG2C;
    const int A = 1 << log2A;
    const int log2n = log2A + log2M;
    float* sr = smem;
    float* si = sr + A * C;
    float* tw_r = si + A * C;
    float* tw_i = tw_r + A / 2;
    const long long p = blockIdx.y;
    const int c0 = blockIdx.x * C;
    build_twiddles(tw_r, tw_i, log2A);

    const In* xp = x + p * in_stride;
    const float* xip = INVERSE ? xi + p * in_stride : nullptr;
    const bool x1_real = PAIR && p < x1_rows;
    const In* x1p = x1_real ? x1 + p * x1_stride : nullptr;
    const float x1_silence = PAIR ? dequant(wire_silence<In>()) : 0.0f;
    for (int e = threadIdx.x; e < A * C; e += blockDim.x) {
        const int a = e >> LOG2C;
        const int col = c0 + (e & (C - 1));
        const long long idx = ((long long)a << log2M) + col;
        if (!INVERSE) {
            const bool in = idx < w_len;
            sr[e] = in ? dequant(xp[idx]) : 0.0f;
            if (PAIR)
                si[e] = in ? (x1_real ? dequant(x1p[idx]) : x1_silence) : 0.0f;
            else
                si[e] = 0.0f;
        } else {
            // conjugate cross twiddle BEFORE undoing the major FFT
            const float vr = (float)xp[idx], vi = xip[idx];
            float c, s;
            cross_twiddle(brev_bits(a, log2A) * col, log2n, 1.0f, &c, &s);
            sr[e] = vr * c - vi * s;
            si[e] = vr * s + vi * c;
        }
    }
    __syncthreads();
    dif_stages<!INVERSE>(sr, si, tw_r, tw_i, log2A, LOG2C);

    const int rows = INVERSE ? a_crop : A;
    float* yrp = yr + p * ((long long)rows << log2M);
    float* yip = yi + p * ((long long)rows << log2M);
    for (int e = threadIdx.x; e < rows * C; e += blockDim.x) {
        const int a = e >> LOG2C;
        const int col = c0 + (e & (C - 1));
        const long long idx = ((long long)a << log2M) + col;
        if (!INVERSE) {
            // physical row a holds frequency brev(a): twiddle W_n^{brev(a)*col}
            float c, s;
            cross_twiddle(brev_bits(a, log2A) * col, log2n, -1.0f, &c, &s);
            const float vr = sr[e], vi = si[e];
            yrp[idx] = vr * c - vi * s;
            yip[idx] = vr * s + vi * c;
        } else {
            yrp[idx] = sr[e];
            yip[idx] = si[e];
        }
    }
}

// FORWARD / INVERSE: one block per contiguous M row of [rows, M] planes, the
// DIF over the row (inverse: bit-reversed in, natural out, unscaled).
// PRODUCT: one block per (row a, window b), blockIdx.x = a*B + b; the window
// row X[b, a] stays in registers (PER elements per thread, M <= PER *
// MINOR_THREADS) while the block loops over the Qh query pairs:
// V = X*T[q, a] -> inverse DIF -> out row (b*Qh + q, a) of [B*Qh, A, M].
template <int MODE, int PER>
__global__ void __launch_bounds__(MINOR_THREADS)
minor_pass(const float* __restrict__ xr, const float* __restrict__ xi,
           const float* __restrict__ tr, const float* __restrict__ ti,
           float* __restrict__ yr, float* __restrict__ yi, int log2M, int A,
           int B, int Qh) {
    extern __shared__ float smem[];
    const int M = 1 << log2M;
    float* sr = smem;
    float* si = sr + M;
    float* tw_r = si + M;
    float* tw_i = tw_r + M / 2;
    build_twiddles(tw_r, tw_i, log2M);

    if (MODE != MINOR_PRODUCT) {
        const long long row = (long long)blockIdx.x << log2M;
        for (int e = threadIdx.x; e < M; e += blockDim.x) {
            sr[e] = xr[row + e];
            si[e] = xi[row + e];
        }
        __syncthreads();
        dif_stages<MODE == MINOR_FORWARD>(sr, si, tw_r, tw_i, log2M, 0);
        for (int e = threadIdx.x; e < M; e += blockDim.x) {
            yr[row + e] = sr[e];
            yi[row + e] = si[e];
        }
        return;
    }

    const int a = blockIdx.x / B;
    const int b = blockIdx.x - a * B;
    const long long xrow = (((long long)b * A + a) << log2M);
    float vxr[PER], vxi[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int e = threadIdx.x + k * MINOR_THREADS;
        if (e < M) {
            vxr[k] = xr[xrow + e];
            vxi[k] = xi[xrow + e];
        }
    }
    for (int q = 0; q < Qh; ++q) {
        const long long trow = (((long long)q * A + a) << log2M);
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            const int e = threadIdx.x + k * MINOR_THREADS;
            if (e < M) {
                const float t_r = tr[trow + e], t_i = ti[trow + e];
                sr[e] = vxr[k] * t_r - vxi[k] * t_i;
                si[e] = vxr[k] * t_i + vxi[k] * t_r;
            }
        }
        __syncthreads();
        dif_stages<false>(sr, si, tw_r, tw_i, log2M, 0);
        const long long orow =
            ((((long long)b * Qh + q) * A + a) << log2M);
        for (int e = threadIdx.x; e < M; e += blockDim.x) {
            yr[orow + e] = sr[e];
            yi[orow + e] = si[e];
        }
        __syncthreads();  // the next query overwrites the tile
    }
}

bool factors_fit(int log2A, int log2M) {
    return log2A >= 1 && log2M >= 1 && log2A <= MAX_LOG2_FACTOR &&
           log2M <= MAX_LOG2_FACTOR;
}

// Strip width of the major pass: 8 columns up to A = 2048, 4 at A = 4096,
// so the [A, C] complex tile stays at 128 KB of shared memory.
template <typename In, bool INVERSE, bool PAIR, int LOG2C>
int launch_major_cols(const In* x, const float* xi, long long in_stride,
                      const In* x1, long long x1_stride, int x1_rows,
                      float* yr, float* yi, int P, int log2A, int log2M,
                      long long w_len, int a_crop, cudaStream_t stream) {
    auto kern = major_pass<In, INVERSE, PAIR, LOG2C>;
    const size_t A = (size_t)1 << log2A;
    const size_t smem = (2 * A * ((size_t)1 << LOG2C) + A) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((1 << log2M) >> LOG2C, P);
    kern<<<grid, MAJOR_THREADS, smem, stream>>>(
        x, xi, in_stride, x1, x1_stride, x1_rows, yr, yi, log2A, log2M,
        w_len, a_crop);
    return (int)cudaGetLastError();
}

template <typename In, bool INVERSE, bool PAIR = false>
int launch_major(const In* x, const float* xi, long long in_stride,
                 const In* x1, long long x1_stride, int x1_rows, float* yr,
                 float* yi, int P, int log2A, int log2M, long long w_len,
                 int a_crop, cudaStream_t stream) {
    if (!factors_fit(log2A, log2M) || log2M < 3)
        return (int)cudaErrorInvalidValue;
    if (log2A <= 11)
        return launch_major_cols<In, INVERSE, PAIR, 3>(
            x, xi, in_stride, x1, x1_stride, x1_rows, yr, yi, P, log2A,
            log2M, w_len, a_crop, stream);
    return launch_major_cols<In, INVERSE, PAIR, 2>(
        x, xi, in_stride, x1, x1_stride, x1_rows, yr, yi, P, log2A, log2M,
        w_len, a_crop, stream);
}

// The minor pass's tile: 3*M floats (the row and its twiddle table), 48 KB
// at M = 4096, the most a block takes without the opt-in; the opt-in is set
// anyway so that a larger tile fails loudly at launch, not silently.
template <int MODE, int PER>
int launch_minor(int blocks, const float* xr, const float* xi,
                 const float* tr, const float* ti, float* yr, float* yi,
                 int log2M, int A, int B, int Qh, cudaStream_t stream) {
    auto kern = minor_pass<MODE, PER>;
    const size_t smem = 3 * ((size_t)1 << log2M) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<blocks, MINOR_THREADS, smem, stream>>>(
        xr, xi, tr, ti, yr, yi, log2M, A, B, Qh);
    return (int)cudaGetLastError();
}

// dtype: 0 = uint8 (mulaw8 wire), 1 = int16, 2 = float32.
template <bool PAIR>
int launch_major_fwd_wire(int dtype, const void* x, long long in_stride,
                          const void* x1, long long x1_stride, int x1_rows,
                          float* yr, float* yi, int P, int log2A, int log2M,
                          long long w_len, cudaStream_t s) {
    switch (dtype) {
        case 0:
            return launch_major<uint8_t, false, PAIR>(
                (const uint8_t*)x, nullptr, in_stride, (const uint8_t*)x1,
                x1_stride, x1_rows, yr, yi, P, log2A, log2M, w_len, 0, s);
        case 1:
            return launch_major<int16_t, false, PAIR>(
                (const int16_t*)x, nullptr, in_stride, (const int16_t*)x1,
                x1_stride, x1_rows, yr, yi, P, log2A, log2M, w_len, 0, s);
        case 2:
            return launch_major<float, false, PAIR>(
                (const float*)x, nullptr, in_stride, (const float*)x1,
                x1_stride, x1_rows, yr, yi, P, log2A, log2M, w_len, 0, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

int am_major_fwd_wire(int dtype, const void* x, long long in_stride,
                      float* yr, float* yi, int P, int log2A, int log2M,
                      long long w_len, void* stream) {
    return launch_major_fwd_wire<false>(dtype, x, in_stride, nullptr, 0, 0,
                                        yr, yi, P, log2A, log2M, w_len,
                                        (cudaStream_t)stream);
}

// fft(w0 + i*w1): row p of x0 is the real plane's window, row p of x1 (for
// p < x1_rows) the imaginary plane's; later rows pair with wire silence.
int am_major_fwd_wire2(int dtype, const void* x0, long long x0_stride,
                       const void* x1, long long x1_stride, int x1_rows,
                       float* yr, float* yi, int P, int log2A, int log2M,
                       long long w_len, void* stream) {
    return launch_major_fwd_wire<true>(dtype, x0, x0_stride, x1, x1_stride,
                                       x1_rows, yr, yi, P, log2A, log2M,
                                       w_len, (cudaStream_t)stream);
}

// The forward major pass of complex f32 [P, A, M] planes (cross twiddle
// after the DIF): the pair mode with both planes as f32 rows of stride n.
int am_major_forward(const float* xr, const float* xi, float* yr, float* yi,
                     int P, int log2A, int log2M, void* stream) {
    const long long n = 1LL << (log2A + log2M);
    return launch_major<float, false, true>(
        xr, nullptr, n, xi, n, P, yr, yi, P, log2A, log2M, n, 0,
        (cudaStream_t)stream);
}

int am_major_inverse(const float* xr, const float* xi, float* yr, float* yi,
                     int P, int log2A, int log2M, int a_crop, void* stream) {
    return launch_major<float, true>(
        xr, xi, 1LL << (log2A + log2M), nullptr, 0, 0, yr, yi, P, log2A,
        log2M, 0, a_crop, (cudaStream_t)stream);
}

int am_minor_forward(const float* xr, const float* xi, float* yr, float* yi,
                     int rows, int log2M, void* stream) {
    if (!factors_fit(1, log2M)) return (int)cudaErrorInvalidValue;
    return launch_minor<MINOR_FORWARD, 1>(
        rows, xr, xi, nullptr, nullptr, yr, yi, log2M, 0, 0, 0,
        (cudaStream_t)stream);
}

int am_minor_inverse(const float* xr, const float* xi, float* yr, float* yi,
                     int rows, int log2M, void* stream) {
    if (!factors_fit(1, log2M)) return (int)cudaErrorInvalidValue;
    return launch_minor<MINOR_INVERSE, 1>(
        rows, xr, xi, nullptr, nullptr, yr, yi, log2M, 0, 0, 0,
        (cudaStream_t)stream);
}

int am_minor_product(const float* xr, const float* xi, const float* tr,
                     const float* ti, float* yr, float* yi, int B, int A,
                     int Qh, int log2M, void* stream) {
    if (!factors_fit(1, log2M)) return (int)cudaErrorInvalidValue;
    if (log2M <= 11)
        return launch_minor<MINOR_PRODUCT, 8>(
            A * B, xr, xi, tr, ti, yr, yi, log2M, A, B, Qh,
            (cudaStream_t)stream);
    return launch_minor<MINOR_PRODUCT, 16>(
        A * B, xr, xi, tr, ti, yr, yi, log2M, A, B, Qh,
        (cudaStream_t)stream);
}

}  // extern "C"
