// The minor FFT pass of the scans, for Hopper (sm_90a), on the core of
// fft_passes.cuh.
//
// Replaces the Pallas TPU kernels of audio_matcher_tpu/ops/pallas_fft.py:
//   minor_pass<MINOR_FORWARD, B> <- fft_minor (forward)
//   minor_pass<MINOR_INVERSE, B> <- fft_minor (inverse)
//   minor_pass<MINOR_PRODUCT, B> <- ifft_minor_product (_minor_product_kernel)
// one instantiation per M = 2^B, 2^7 .. 2^14; and builds the per-L twiddle
// table of both passes (twiddle_table).
//
// What is computed. The radix-2 DIF along each contiguous row of M points
// of [rows, M] f32 planes (natural in, bit-reversed out), or its inverse
// (bit-reversed in, natural out, unscaled: the 1/n is folded into the query
// spectra by the caller). The product mode multiplies each window row by
// each query pair's row in registers and runs the inverse on the product,
// so the product planes are never written.
//
// What bounds it on an H100. Every mode streams f32 planes once each way:
// device-memory bytes are the bound (at the batch scan's slab the product
// pass writes 2 x 4.3 GB). Run one radix-2 stage per round trip through
// shared memory, with a barrier after each, the stages would take far
// longer than the bytes.
//
// What the design does about it. The stage groups run in registers, with
// two exchanges through shared memory at M = 2048 (fft_passes.cuh). The
// contiguous end of each row moves as float4: the inverse's and the
// product's input, 16 consecutive points a thread; the forward's output,
// after a 4 x 4 transpose of float4s across each quad of lanes, so that a
// quad's stores are 64 contiguous bytes. The strided end is scalar, a
// warp's 32 lanes on consecutive words. A block is 256 threads, M/16 a row
// (4096/M rows a block), and several blocks share an SM, so every thread
// has its 16 loads per plane in flight while other blocks run stages. At
// M = 8192 and 16384 (fft_len 2^25 - 2^28) a row needs more than 256
// threads of 16 points: a block is then one row of M/16 threads (512,
// 1024), its tiles 32 or 68 KB a plane; at 16384 a thread has 64 registers
// for its 32 points, so the tile is MajorTile<0>'s padded line, whose steps
// are immediates (fft_passes.cuh), not the XOR-swizzled MinorTile. The
// product mode keeps the window row X in shared memory across the Qh query
// pairs and multiplies X*T straight into the first inverse group; at M =
// 16384 it reads X again for each pair (product_row_wide: its 128 KB row
// stays in L2), since X and two tiles would pass 227 KB and a thread's 64
// registers leave nothing to hold across the pairs.
//
// Each C entry point returns cudaGetLastError() of its launch, or
// cudaErrorInvalidValue for a factor it has no instantiation for.

#include "fft_passes.cuh"

namespace {

constexpr int MINOR_THREADS = 256;
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may use

enum MinorMode { MINOR_FORWARD, MINOR_INVERSE, MINOR_PRODUCT };

// Threads of a block: MINOR_THREADS (4096/M rows) up to M = 4096, one row
// of M/16 above (ops/fft_plan.py's minor_threads).
__host__ __device__ constexpr int minor_threads(int log2M) {
    return log2M - LOG2_PTS > 8 ? 1 << (log2M - LOG2_PTS) : MINOR_THREADS;
}
// The exchange tile of a plane: the XOR-swizzled MinorTile (conflict-free)
// up to M = 8192; MajorTile<0>'s padded line at 16384 (ops/fft_plan.py's
// minor_address), one float more each 16.
template <int LOG2M>
using MinorTileOf =
    std::conditional_t<(LOG2M > 13), MajorTile<0>, MinorTile>;
__host__ __device__ constexpr int minor_tile_floats(int log2M) {
    return minor_threads(log2M) * PTS +
           (log2M > 13 ? minor_threads(log2M) : 0);
}
// Whether the product mode keeps its window row X in shared memory: up to
// M = 8192 (ops/fft_plan.py's minor_smem_bytes).
__host__ __device__ constexpr bool minor_x_in_smem(int log2M) {
    return log2M <= 13;
}
// Floats of shared memory: the two planes' exchange tiles, and the
// product's X planes where they are kept.
template <int MODE, int LOG2M>
__host__ __device__ constexpr int minor_smem_floats() {
    return 2 * minor_tile_floats(LOG2M) +
           (MODE == MINOR_PRODUCT && minor_x_in_smem(LOG2M)
                ? 2 * minor_threads(LOG2M) * PTS
                : 0);
}
// Blocks an SM must hold (so registers a thread): 3 (85 registers) for the
// forward and inverse, 2 for the product at M = 2048 (128), no bound for
// the product at the other M <= 4096, where ptxas spills within 128; one
// row a block above: 1 (128 registers at M = 8192's 512 threads, 64 at
// 16384's 1024).
template <int MODE, int LOG2M>
__host__ __device__ constexpr int minor_min_blocks() {
    if (minor_threads(LOG2M) > MINOR_THREADS) return 1;
    return MODE != MINOR_PRODUCT ? 3 : LOG2M == 11 ? 2 : 1;
}

// tw[m + j] = exp(-2*pi*i*j/(2m)) for m = 2^p < L, j < m; tw[0] = 1.
__global__ void twiddle_table(float2* __restrict__ tw, int L) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= L) return;
    if (k == 0) {
        tw[0] = make_float2(1.0f, 0.0f);
        return;
    }
    const int p = 31 - __clz(k);
    float s, c;
    sincospif(-ldexpf((float)(k - (1 << p)), -p), &s, &c);
    tw[k] = make_float2(c, s);
}

// Contiguous end of a row: the 16 points (u << 4) .. (u << 4) + 15.
__device__ __forceinline__ void load_run(float (&v)[PTS],
                                         const float* __restrict__ p) {
#pragma unroll
    for (int k = 0; k < PTS / 4; ++k) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(p) + k);
        v[4 * k] = f.x;
        v[4 * k + 1] = f.y;
        v[4 * k + 2] = f.z;
        v[4 * k + 3] = f.w;
    }
}

// A 4x4 transpose of float4s across the four lanes of a quad (lane & 3):
// afterwards lane l's float4 k is the former float4 l of lane k.
__device__ __forceinline__ void quad_transpose(float (&v)[PTS], int lane) {
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
        const bool hi = lane & m;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            if (k & m) continue;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float send = hi ? v[4 * k + e] : v[4 * (k ^ m) + e];
                const float got = __shfl_xor_sync(0xffffffffu, send, m);
                if (hi)
                    v[4 * k + e] = got;
                else
                    v[4 * (k ^ m) + e] = got;
            }
        }
    }
}

// The runs of 16 points of a quad of threads u .. u + 3 (u mod 4 = 0),
// stored so that each float4 store of a quad writes 64 contiguous bytes.
__device__ __forceinline__ void store_runs(float* __restrict__ row,
                                           float (&v)[PTS], int u) {
    quad_transpose(v, u & 3);
    float* q = row + ((u & ~3) << LOG2_PTS) + ((u & 3) << 2);
#pragma unroll
    for (int k = 0; k < PTS / 4; ++k)
        *reinterpret_cast<float4*>(q + (k << LOG2_PTS)) =
            make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

// The product mode at M = 16384: row w = a*B + b is the block's one row
// (w = blockIdx.x < rows = A*B). For each query pair q: V = X*T[q, a], X
// read from device memory each time (L2 holds the row across the pairs),
// the inverse DIF, out row (b*Qh + q, a). The block's place and the
// thread's are computed anew for each pair where they are needed (opaque),
// so that nothing derived from them is held across the stages.
template <int LOG2M>
__device__ __forceinline__ void product_row_wide(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const float* __restrict__ tr, const float* __restrict__ ti,
    float* __restrict__ yr, float* __restrict__ yi,
    const float2* __restrict__ tw, int A, int B, int Qh, float* smem) {
    constexpr int LOG2T = LOG2M - LOG2_PTS;
    const MinorTileOf<LOG2M> tile{0};
    float vr[PTS], vi[PTS];
#pragma unroll 1
    for (int q = 0; q < Qh; ++q) {
        {
            const int w = opaque((int)blockIdx.x), a = w / B, b = w - a * B;
            const long long at = ((long long)a << LOG2M) +
                                 (opaque((int)threadIdx.x) << LOG2_PTS);
            const float4* x_r = reinterpret_cast<const float4*>(
                xr + ((long long)b * A << LOG2M) + at);
            const float4* x_i = reinterpret_cast<const float4*>(
                xi + ((long long)b * A << LOG2M) + at);
            const float4* t_r = reinterpret_cast<const float4*>(
                tr + ((long long)q * A << LOG2M) + at);
            const float4* t_i = reinterpret_cast<const float4*>(
                ti + ((long long)q * A << LOG2M) + at);
#pragma unroll
            for (int k = 0; k < PTS / 4; ++k) {  // V = X * T, a float4 a time
                const float4 p = __ldg(x_r + k), pi = __ldg(x_i + k);
                const float4 t = __ldg(t_r + k), tj = __ldg(t_i + k);
                const float xa[4] = {p.x, p.y, p.z, p.w};
                const float xb[4] = {pi.x, pi.y, pi.z, pi.w};
                const float ta[4] = {t.x, t.y, t.z, t.w};
                const float tb[4] = {tj.x, tj.y, tj.z, tj.w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    vr[4 * k + e] = xa[e] * ta[e] - xb[e] * tb[e];
                    vi[4 * k + e] = xa[e] * tb[e] + xb[e] * ta[e];
                }
            }
        }
        transform<false, true, LOG2M>(vr, vi, smem,
                                      smem + minor_tile_floats(LOG2M), tile,
                                      opaque((int)threadIdx.x), tw);
        const int w = opaque((int)blockIdx.x), a = w / B, b = w - a * B;
        const long long orow =
            ((((long long)b * Qh + q) * A + a) << LOG2M) +
            opaque((int)threadIdx.x);
#pragma unroll
        for (int r = 0; r < PTS; ++r) {
            yr[orow + (r << LOG2T)] = vr[r];
            yi[orow + (r << LOG2T)] = vi[r];
        }
    }
}

// minor_threads(LOG2M) threads, M/16 per row, so 4096/M rows per block up
// to M = 4096 and one above (row index blockIdx.x * rows_per_block + line;
// rows past `rows` only take part in the exchanges and shuffles); at least
// minor_min_blocks blocks per SM.
// FORWARD / INVERSE: row `row` of [rows, M] planes, the DIF over the row
// (inverse: bit-reversed in, natural out, unscaled).
// PRODUCT: row w = a*B + b for w < rows = A*B; the window row X[b, a] stays
// in shared memory while the block loops over the Qh query pairs (up to M =
// 8192; product_row_wide above):
// V = X*T[q, a] -> inverse DIF -> out row (b*Qh + q, a) of [B*Qh, A, M].
template <int MODE, int LOG2M>
__global__ void __launch_bounds__(minor_threads(LOG2M),
                                  minor_min_blocks<MODE, LOG2M>())
minor_pass(const float* __restrict__ xr, const float* __restrict__ xi,
           const float* __restrict__ tr, const float* __restrict__ ti,
           float* __restrict__ yr, float* __restrict__ yi,
           const float2* __restrict__ tw, long long rows, int A, int B,
           int Qh) {
    extern __shared__ float smem[];
    constexpr int THREADS = minor_threads(LOG2M);
    constexpr int TILE = minor_tile_floats(LOG2M);  // floats of one plane
    constexpr int LOG2T = LOG2M - LOG2_PTS;  // threads per row, log2
    if constexpr (MODE == MINOR_PRODUCT && !minor_x_in_smem(LOG2M)) {
        product_row_wide<LOG2M>(xr, xi, tr, ti, yr, yi, tw, A, B, Qh, smem);
        return;
    }
    const int line = threadIdx.x >> LOG2T;
    const int u = threadIdx.x & ((1 << LOG2T) - 1);
    const long long row =
        (long long)blockIdx.x * (THREADS >> LOG2T) + line;
    const bool live = row < rows;
    const MinorTileOf<LOG2M> tile{line << LOG2M};  // line 0 past 4096
    float* sr = smem;
    float* si = smem + TILE;
    float vr[PTS], vi[PTS];

    if (MODE != MINOR_PRODUCT) {
        const long long base = row << LOG2M;
        if (MODE == MINOR_FORWARD) {
#pragma unroll
            for (int r = 0; r < PTS; ++r) {
                vr[r] = live ? __ldg(xr + base + u + (r << LOG2T)) : 0.0f;
                vi[r] = live ? __ldg(xi + base + u + (r << LOG2T)) : 0.0f;
            }
            transform<true, true, LOG2M>(vr, vi, sr, si, tile, u, tw);
            if (live) {
                store_runs(yr + base, vr, u);
                store_runs(yi + base, vi, u);
            }
        } else {
            if (live) {
                load_run(vr, xr + base + (u << LOG2_PTS));
                load_run(vi, xi + base + (u << LOG2_PTS));
            } else {
#pragma unroll
                for (int r = 0; r < PTS; ++r) vr[r] = vi[r] = 0.0f;
            }
            transform<false, true, LOG2M>(vr, vi, sr, si, tile, u, tw);
            if (live) {
#pragma unroll
                for (int r = 0; r < PTS; ++r) {
                    yr[base + u + (r << LOG2T)] = vr[r];
                    yi[base + u + (r << LOG2T)] = vi[r];
                }
            }
        }
        return;
    }

    const int a = live ? int(row / B) : 0;
    const int b = live ? int(row - (long long)a * B) : 0;
    // The window row stays in shared memory (its own 4 float4 per plane a
    // thread, float4 k of thread t at xs[k * THREADS + t]: a warp's reads
    // are consecutive) while the block loops over the query pairs. Each
    // thread reads back only what it wrote: no barrier.
    float4* xs = reinterpret_cast<float4*>(smem + 2 * TILE);
    const long long xrow = (((long long)b * A + a) << LOG2M) + (u << LOG2_PTS);
#pragma unroll
    for (int k = 0; k < PTS / 4; ++k) {
        xs[k * THREADS + threadIdx.x] =
            __ldg(reinterpret_cast<const float4*>(xr + xrow) + k);
        xs[(k + PTS / 4) * THREADS + threadIdx.x] =
            __ldg(reinterpret_cast<const float4*>(xi + xrow) + k);
    }
#pragma unroll 1
    for (int q = 0; q < Qh; ++q) {
        const float4* trq = reinterpret_cast<const float4*>(
            tr + (((long long)q * A + a) << LOG2M) + (u << LOG2_PTS));
        const float4* tiq = reinterpret_cast<const float4*>(
            ti + (((long long)q * A + a) << LOG2M) + (u << LOG2_PTS));
#pragma unroll
        for (int k = 0; k < PTS / 4; ++k) {  // V = X * T, a float4 at a time
            const float4 x_r = xs[k * THREADS + threadIdx.x];
            const float4 x_i = xs[(k + PTS / 4) * THREADS + threadIdx.x];
            const float4 t_r = __ldg(trq + k), t_i = __ldg(tiq + k);
            const float xa[4] = {x_r.x, x_r.y, x_r.z, x_r.w};
            const float xb[4] = {x_i.x, x_i.y, x_i.z, x_i.w};
            const float ta[4] = {t_r.x, t_r.y, t_r.z, t_r.w};
            const float tb[4] = {t_i.x, t_i.y, t_i.z, t_i.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                vr[4 * k + e] = xa[e] * ta[e] - xb[e] * tb[e];
                vi[4 * k + e] = xa[e] * tb[e] + xb[e] * ta[e];
            }
        }
        transform<false, true, LOG2M>(vr, vi, sr, si, tile, u, tw);
        if (live) {
            const long long orow =
                ((((long long)b * Qh + q) * A + a) << LOG2M) + u;
#pragma unroll
            for (int r = 0; r < PTS; ++r) {
                yr[orow + (r << LOG2T)] = vr[r];
                yi[orow + (r << LOG2T)] = vi[r];
            }
        }
    }
}

template <int MODE>
int launch_minor(long long rows, const float* xr, const float* xi,
                 const float* tr, const float* ti, float* yr, float* yi,
                 const float2* tw, int log2M, int A, int B, int Qh,
                 cudaStream_t stream) {
    if (!factor_fits(log2M) || rows < 1) return (int)cudaErrorInvalidValue;
    return with_factor(log2M, [&](auto L) {
        constexpr int LOG2M = decltype(L)::value;
        constexpr int THREADS = minor_threads(LOG2M);
        const long long per_block = THREADS >> (LOG2M - LOG2_PTS);
        const long long blocks = (rows + per_block - 1) / per_block;
        if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
        // the exchange tiles; the product's window rows beside them
        constexpr size_t smem =
            minor_smem_floats<MODE, LOG2M>() * sizeof(float);
        static_assert(smem <= MAX_SMEM, "the minor pass's shared memory");
        auto kern = minor_pass<MODE, LOG2M>;
        cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        kern<<<(unsigned)blocks, THREADS, smem, stream>>>(
            xr, xi, tr, ti, yr, yi, tw, rows, A, B, Qh);
        return (int)cudaGetLastError();
    });
}

}  // namespace

extern "C" {

// The per-stage twiddle table of length L (see twiddle_table).
int am_twiddles(float* tw, int log2L, void* stream) {
    if (!factor_fits(log2L)) return (int)cudaErrorInvalidValue;
    const int L = 1 << log2L;
    twiddle_table<<<(L + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        (float2*)tw, L);
    return (int)cudaGetLastError();
}

int am_minor_forward(const float* xr, const float* xi, float* yr, float* yi,
                     const float* tw, long long rows, int log2M,
                     void* stream) {
    return launch_minor<MINOR_FORWARD>(
        rows, xr, xi, nullptr, nullptr, yr, yi, (const float2*)tw, log2M, 0,
        1, 0, (cudaStream_t)stream);
}

int am_minor_inverse(const float* xr, const float* xi, float* yr, float* yi,
                     const float* tw, long long rows, int log2M,
                     void* stream) {
    return launch_minor<MINOR_INVERSE>(
        rows, xr, xi, nullptr, nullptr, yr, yi, (const float2*)tw, log2M, 0,
        1, 0, (cudaStream_t)stream);
}

int am_minor_product(const float* xr, const float* xi, const float* tr,
                     const float* ti, float* yr, float* yi, const float* tw,
                     int B, int A, int Qh, int log2M, void* stream) {
    if (B < 1 || A < 1 || Qh < 1) return (int)cudaErrorInvalidValue;
    return launch_minor<MINOR_PRODUCT>(
        (long long)A * B, xr, xi, tr, ti, yr, yi, (const float2*)tw, log2M, A,
        B, Qh, (cudaStream_t)stream);
}

}  // extern "C"
