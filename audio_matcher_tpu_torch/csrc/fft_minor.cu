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
// threads of 16 points: the forward and inverse modes then share each row
// over a thread-block cluster of M/4096 blocks of that same shape
// (minor_cluster_pass, below). The product mode there is one row a block
// of M/16 threads (512, 1024), its tiles 32 or 68 KB a plane; at 16384 a
// thread has 64 registers for its 32 points, so the tile is MajorTile<0>'s
// padded line, whose steps are immediates (fft_passes.cuh), not the
// XOR-swizzled MinorTile. The product mode keeps the window row X in
// shared memory across the Qh query pairs and multiplies X*T straight into
// the first inverse group; at M = 16384 it reads X again for each pair
// (product_row_wide: its 128 KB row stays in L2), since X and two tiles
// would pass 227 KB and a thread's 64 registers leave nothing to hold
// across the pairs.
//
// Each C entry point returns cudaGetLastError() of its launch, or
// cudaErrorInvalidValue for a factor it has no instantiation for.

#include "fft_passes.cuh"

namespace {

constexpr int MINOR_THREADS = 256;
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may use

enum MinorMode { MINOR_FORWARD, MINOR_INVERSE, MINOR_PRODUCT };

// Threads of a block: MINOR_THREADS (4096/M rows) up to M = 4096, one row
// of M/16 above (ops/fft_plan.py's minor_threads; the forward and inverse
// modes run on clusters there, MinorCluster).
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
// the product at the other M <= 4096, where ptxas spills within 128; the
// product's one row a block above: 1 (128 registers at M = 8192's 512
// threads, 64 at 16384's 1024).
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
// to M = 4096 and one above, where only the product mode runs here (row
// index blockIdx.x * rows_per_block + line;
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

// ------------------------------------------------ the rows on clusters
// The forward and inverse modes at M = 8192 and 16384 (fft_len 2^25 -
// 2^28). A cluster of K = M/4096 blocks (2, 4) shares a row, one row a
// cluster, and each block keeps the shape of M = 4096: 256 threads of 16
// points. The top stage group (window [W0, W0 + 4), W0 = log2 M - 4: its
// stages take the index bits above 11) runs on thread U = b*256 + t of the
// cluster (b the block's rank, t its thread), which holds the points U +
// 2^W0 * r. Every other group's bits lie below 12: once the top group is
// done (forward), or before it starts (inverse), block b holds the points
// b*4096 .. b*4096 + 4095 and runs those groups as a block of M = 4096
// does, through a swizzled MinorTile. One exchange through distributed
// shared memory moves every point once between the two layouts, a scalar
// store into the peer's tile; on both sides a warp's 32 words are
// consecutive (no bank conflict).
//
// What bounds it is latency: each step of a row waits for the one before,
// and the blocks of a cluster for each other. So a block keeps 64
// registers a thread and at most 48 KB of shared memory, and an SM holds 4
// blocks whose rows overlap (3 blocks of 80 registers ran 10 % slower on an
// H100, probe_minor_wide.py); and a row has one cluster barrier besides
// the one that tells a block its peers have started: the forward's groups
// after the exchange run in the tile the points came in, the inverse's
// before it in a plane of its own, so no block waits for a peer to be done
// with its tile. Within 64 registers the forward forms every twiddle of a
// stage from one table entry (rooted_stage: the twiddles of W = 0 are
// constants), the inverse its top group's (their entries loaded before the
// barrier, whose wait hides them). ops/fft_plan.py mirrors every index map
// (minor_cluster_*) and twiddle, and a CPU test runs the decomposition
// through them.
constexpr int CLUSTER_ROW_LOG2 = 12;  // points of a row a block holds
constexpr int CLUSTER_TILE = 1 << CLUSTER_ROW_LOG2;  // floats of a plane
constexpr int CLUSTER_BLOCKS = 4;  // blocks an SM (64 registers a thread)
// Floats of a block's shared memory: the tile its peers send into (two
// planes), and for the inverse a plane of its own for the exchanges before
// its sends (the forward's come after them, in the tile they arrived in).
__host__ __device__ constexpr int cluster_smem_floats(bool forward) {
    return (forward ? 2 : 3) * CLUSTER_TILE;
}

template <int LOG2M>
struct MinorCluster {
    static constexpr int LOG2K = LOG2M - CLUSTER_ROW_LOG2;  // blocks a row
    static constexpr int K = 1 << LOG2K;
    static constexpr int W0 = LOG2M - LOG2_PTS;  // the top group's window
    static constexpr int W1 = Plan<LOG2M>::w(1);  // the next group's
    static_assert(LOG2K >= 1 && LOG2K <= 2 && W0 == 8 + LOG2K &&
                      Plan<LOG2M>::w(0) == W0 && Plan<LOG2M>::qlo(0) == 0 &&
                      Plan<LOG2M>::k(0) == LOG2_PTS,
                  "the top group holds the bits above a block's");
    // the inverse's sends: the destination (bits 8 .. W0 - 1 of the
    // point's index) comes from the register alone
    static_assert(W1 <= 8 && W0 <= W1 + LOG2_PTS &&
                      W1 + LOG2_PTS <= CLUSTER_ROW_LOG2,
                  "the next group's window");
};

// The slot of a block's tile that receives point g of the row for the
// inverse's top group (block (g >> 8) mod K): thread g mod 256, register
// g >> W0 (ops/fft_plan.py's minor_cluster_inverse_slot). A bit map: the
// slot of a | b is the slot of a plus that of b for disjoint a and b.
template <int LOG2M>
__host__ __device__ constexpr int inverse_slot(int g) {
    return (g & 255) | ((g >> MinorCluster<LOG2M>::W0) << 8);
}

// W_{2^(q+1)}^j = exp(-pi i e / 8), e = j * 2^(3 - q), for q < 4 and j <
// 2^q: constants once the loops are unrolled.
__device__ __forceinline__ float2 small_root(int q, int j) {
    constexpr float COS[8] = {1.0f, 0.923879532511286756f,
                              0.707106781186547524f, 0.382683432365089772f,
                              0.0f, -0.382683432365089772f,
                              -0.707106781186547524f, -0.923879532511286756f};
    constexpr float NSIN[8] = {0.0f, -0.382683432365089772f,
                               -0.707106781186547524f,
                               -0.923879532511286756f, -1.0f,
                               -0.923879532511286756f,
                               -0.707106781186547524f,
                               -0.382683432365089772f};
    const int e = j << (3 - q);
    return make_float2(COS[e], NSIN[e]);
}

// One stage q of a group at window W (run_group's butterflies), the
// twiddle of the pairs r0 mod 2^q = j being b * W_{2^(q+1)}^j, b =
// W_{2^(W+q+1)}^(u mod 2^W) the table's entry for j = 0 (1 at W = 0, where
// every twiddle is a constant): exact for j = 0 and for W = -i.
template <bool FORWARD, int W>
__device__ __forceinline__ void rooted_stage(float (&xr)[PTS],
                                             float (&xi)[PTS], int q,
                                             float2 b) {
    const int half = 1 << q;
#pragma unroll
    for (int j = 0; j < half; ++j) {
        const float2 w = j == 0          ? b
                         : 2 * j == half ? make_float2(b.y, -b.x)
                         : W == 0        ? small_root(q, j)
                                         : cmul(b, small_root(q, j));
#pragma unroll
        for (int r0 = j; r0 < PTS; r0 += 2 * half) {
            if (W == 0 && j == 0)
                butterfly<FORWARD, TW_ONE>(xr, xi, r0, r0 | half, w);
            else if (W == 0 && 2 * j == half)
                butterfly<FORWARD, TW_MINUS_I>(xr, xi, r0, r0 | half, w);
            else
                butterfly<FORWARD, TW_ANY>(xr, xi, r0, r0 | half, w);
        }
    }
}

// The stages of a group at window W on register bits QLO .. QLO + K - 1,
// one table entry a stage (rooted_stage), loaded in its stage.
template <bool FORWARD, int W, int QLO, int K>
__device__ __forceinline__ void run_rooted_group(
    float (&xr)[PTS], float (&xi)[PTS], int u,
    const float2* __restrict__ tw) {
#pragma unroll
    for (int s = 0; s < LOG2_PTS; ++s) {
        const int q = FORWARD ? LOG2_PTS - 1 - s : s;
        if (q < QLO || q >= QLO + K) continue;
        asm volatile("" ::: "memory");  // this stage's load stays in it
        rooted_stage<FORWARD, W>(
            xr, xi, q,
            W == 0 ? make_float2(1.0f, 0.0f)
                   : load_twiddle(tw + (1 << (W + q)) + (u & ((1 << W) - 1))));
    }
}

// The top group (window W0, all four register bits) of thread U, its four
// table entries loaded ahead (load_top_roots), so that their latency hides
// behind a cluster barrier.
template <int W0>
__device__ __forceinline__ void load_top_roots(float2 (&b)[LOG2_PTS],
                                               const float2* __restrict__ tw,
                                               int U) {
#pragma unroll
    for (int q = 0; q < LOG2_PTS; ++q)
        b[q] = load_twiddle(tw + (1 << (W0 + q)) + U);
}
template <bool FORWARD, int W0>
__device__ __forceinline__ void run_top_group(float (&xr)[PTS],
                                              float (&xi)[PTS],
                                              const float2 (&b)[LOG2_PTS]) {
#pragma unroll
    for (int s = 0; s < LOG2_PTS; ++s) {
        const int q = FORWARD ? LOG2_PTS - 1 - s : s;
        rooted_stage<FORWARD, W0>(xr, xi, q, b[q]);
    }
}

// Forward: thread U's register r (point U + 2^W0 * r) goes to block r >>
// (4 - log2 K), word U + 2^W0 * (r mod 2^(4 - log2 K)) of each plane.
template <int LOG2M>
__device__ __forceinline__ void send_forward(const float (&vr)[PTS],
                                             const float (&vi)[PTS],
                                             float* smem, int U) {
    using Cl = MinorCluster<LOG2M>;
    constexpr int LOW = LOG2_PTS - Cl::LOG2K;  // register bits in a block
#pragma unroll
    for (int d = 0; d < Cl::K; ++d) {
        const unsigned at = peer_address(smem + U, d);
#pragma unroll
        for (int e = 0; e < (1 << LOW); ++e) {
            store_peer(at + 4 * (e << Cl::W0), vr[(d << LOW) | e]);
            store_peer(at + 4 * (CLUSTER_TILE + (e << Cl::W0)),
                       vi[(d << LOW) | e]);
        }
    }
}

// Inverse: thread t of block b holds the points g = b*4096 + position(t,
// r, W1); each goes to block (g >> 8) mod K, word inverse_slot(g).
template <int LOG2M>
__device__ __forceinline__ void send_inverse(const float (&vr)[PTS],
                                             const float (&vi)[PTS],
                                             float* smem, int b, int t) {
    using Cl = MinorCluster<LOG2M>;
    const int s0 = inverse_slot<LOG2M>((b << CLUSTER_ROW_LOG2) +
                                       position(t, 0, Cl::W1));
#pragma unroll
    for (int d = 0; d < Cl::K; ++d) {
        const unsigned at = peer_address(smem + s0, d);
#pragma unroll
        for (int r = 0; r < PTS; ++r) {
            if ((((r << Cl::W1) >> 8) & (Cl::K - 1)) != d) continue;
            const int off = inverse_slot<LOG2M>(r << Cl::W1);
            store_peer(at + 4 * off, vr[r]);
            store_peer(at + 4 * (CLUSTER_TILE + off), vi[r]);
        }
    }
}

// The contiguous end of a row, loaded: the 16 points (u << 4) .. (u << 4)
// + 15 of each thread of a quad u .. u + 3 (u mod 4 = 0), each float4 load
// of a quad 64 contiguous bytes (store_runs backwards).
__device__ __forceinline__ void load_runs(float (&v)[PTS],
                                          const float* __restrict__ row,
                                          int u) {
    const float4* q = reinterpret_cast<const float4*>(
        row + ((u & ~3) << LOG2_PTS) + ((u & 3) << 2));
#pragma unroll
    for (int k = 0; k < PTS / 4; ++k) {
        const float4 f = __ldg(q + (k << 2));
        v[4 * k] = f.x;
        v[4 * k + 1] = f.y;
        v[4 * k + 2] = f.z;
        v[4 * k + 3] = f.w;
    }
    quad_transpose(v, u & 3);
}

// One row of [rows, M] planes a cluster (row blockIdx.x / K), the DIF over
// the row (inverse: bit-reversed in, natural out, unscaled). The places of
// the row, the block and the thread are computed again where they are
// needed (opaque), so that nothing derived from them is held across the
// stages.
template <bool FORWARD, int LOG2M>
__global__ void __launch_bounds__(MINOR_THREADS, CLUSTER_BLOCKS)
minor_cluster_pass(const float* __restrict__ xr, const float* __restrict__ xi,
                   float* __restrict__ yr, float* __restrict__ yi,
                   const float2* __restrict__ tw) {
    using Cl = MinorCluster<LOG2M>;
    using Pl = Plan<LOG2M>;
    extern __shared__ float smem[];
    float* sr = smem;
    float* si = smem + CLUSTER_TILE;
    const MinorTile tile{0};
    float vr[PTS], vi[PTS];
    static_assert(Pl::NG == 4, "four stage groups");
    cluster_arrive();  // started: the peers may write into this block
    if constexpr (FORWARD) {
        {
            const int U = (cluster_rank() << 8) | (int)threadIdx.x;
            const long long at =
                ((long long)(blockIdx.x >> Cl::LOG2K) << LOG2M) + U;
#pragma unroll
            for (int r = 0; r < PTS; ++r) {
                vr[r] = __ldg(xr + at + (r << Cl::W0));
                vi[r] = __ldg(xi + at + (r << Cl::W0));
            }
        }
        run_rooted_group<true, Cl::W0, 0, LOG2_PTS>(
            vr, vi, (cluster_rank() << 8) | opaque((int)threadIdx.x), tw);
        cluster_wait();  // every block of the cluster has started
        send_forward<LOG2M>(vr, vi, smem,
                            (cluster_rank() << 8) | opaque((int)threadIdx.x));
        cluster_arrive();
        cluster_wait();  // the block's 4096 points are in its tile
        {
            const int p = position(opaque((int)threadIdx.x), 0, Cl::W1);
#pragma unroll
            for (int r = 0; r < PTS; ++r) {
                vr[r] = sr[p + (r << Cl::W1)];
                vi[r] = si[p + (r << Cl::W1)];
            }
        }
        // the other groups in the tile the points came in, the thread's
        // place taken anew for each step
        run_rooted_group<true, Cl::W1, Pl::qlo(1), Pl::k(1)>(
            vr, vi, opaque((int)threadIdx.x), tw);
        exchange<true, Pl::w(1), Pl::w(2)>(vr, vi, sr, si, tile,
                                           opaque((int)threadIdx.x));
        run_rooted_group<true, Pl::w(2), Pl::qlo(2), Pl::k(2)>(
            vr, vi, opaque((int)threadIdx.x), tw);
        exchange<true, Pl::w(2), Pl::w(3)>(vr, vi, sr, si, tile,
                                           opaque((int)threadIdx.x));
        run_rooted_group<true, Pl::w(3), Pl::qlo(3), Pl::k(3)>(
            vr, vi, opaque((int)threadIdx.x), tw);
        const int t = opaque((int)threadIdx.x);
        const long long own =
            ((long long)(opaque((int)blockIdx.x) >> Cl::LOG2K) << LOG2M) +
            (cluster_rank() << CLUSTER_ROW_LOG2);
        store_runs(yr + own, vr, t);
        store_runs(yi + own, vi, t);
    } else {
        float* xt = smem + 2 * CLUSTER_TILE;  // the block's own exchanges
        {
            const int t = threadIdx.x;
            const long long own =
                ((long long)(blockIdx.x >> Cl::LOG2K) << LOG2M) +
                (cluster_rank() << CLUSTER_ROW_LOG2);
            load_runs(vr, xr + own, t);
            load_runs(vi, xi + own, t);
        }
        // the groups below the top one, one plane at a time through xt
        transform<false, false, LOG2M, 0, Pl::NG - 1>(
            vr, vi, xt, xt, tile, opaque((int)threadIdx.x), tw);
        cluster_wait();  // every block of the cluster has started
        send_inverse<LOG2M>(vr, vi, smem, cluster_rank(),
                            opaque((int)threadIdx.x));
        float2 b[LOG2_PTS];
        load_top_roots<Cl::W0>(
            b, tw, (cluster_rank() << 8) | opaque((int)threadIdx.x));
        cluster_arrive();
        cluster_wait();  // thread t's 16 points of the top group are here
        {
            const int t = opaque((int)threadIdx.x);
#pragma unroll
            for (int r = 0; r < PTS; ++r) {
                vr[r] = sr[t + (r << 8)];
                vi[r] = si[t + (r << 8)];
            }
        }
        run_top_group<false, Cl::W0>(vr, vi, b);
        const int U = (cluster_rank() << 8) | opaque((int)threadIdx.x);
        const long long row =
            (long long)(opaque((int)blockIdx.x) >> Cl::LOG2K) << LOG2M;
#pragma unroll
        for (int r = 0; r < PTS; ++r) {
            yr[row + U + (r << Cl::W0)] = vr[r];
            yi[row + U + (r << Cl::W0)] = vi[r];
        }
    }
}

// A cluster pass's launch configuration (clusters of K blocks, a grid of
// one cluster) and the clusters the card holds at once at its shared
// memory (cudaOccupancyMaxActiveClusters).
template <bool FORWARD, int LOG2M>
cudaError_t minor_cluster_config(cudaLaunchConfig_t* cfg,
                                 cudaLaunchAttribute* attr,
                                 cudaStream_t stream, int* clusters) {
    using Cl = MinorCluster<LOG2M>;
    constexpr size_t smem = cluster_smem_floats(FORWARD) * sizeof(float);
    static_assert(CLUSTER_BLOCKS * smem <= MAX_SMEM,
                  "the cluster blocks an SM holds");
    *clusters = 0;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = Cl::K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg->gridDim = dim3(Cl::K);
    cfg->blockDim = dim3(MINOR_THREADS);
    cfg->dynamicSmemBytes = smem;
    cfg->stream = stream;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    return cudaOccupancyMaxActiveClusters(
        clusters, minor_cluster_pass<FORWARD, LOG2M>, cfg);
}

// One cluster a row: refused (cudaErrorLaunchOutOfResources) where the
// card holds no cluster; else its cudaLaunchKernelEx error or
// cudaGetLastError().
template <bool FORWARD, int LOG2M>
int launch_minor_cluster(long long rows, const float* xr, const float* xi,
                         float* yr, float* yi, const float2* tw,
                         cudaStream_t stream) {
    using Cl = MinorCluster<LOG2M>;
    if (rows > (0x7fffffffLL >> Cl::LOG2K)) return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg{};
    cudaLaunchAttribute attr[1];
    int clusters = 0;
    cudaError_t err =
        minor_cluster_config<FORWARD, LOG2M>(&cfg, attr, stream, &clusters);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
    cfg.gridDim = dim3((unsigned)(rows << Cl::LOG2K));
    err = cudaLaunchKernelEx(&cfg, minor_cluster_pass<FORWARD, LOG2M>, xr, xi,
                             yr, yi, tw);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

template <int MODE>
int launch_minor(long long rows, const float* xr, const float* xi,
                 const float* tr, const float* ti, float* yr, float* yi,
                 const float2* tw, int log2M, int A, int B, int Qh,
                 cudaStream_t stream) {
    if (!factor_fits(log2M) || rows < 1) return (int)cudaErrorInvalidValue;
    return with_factor(log2M, [&](auto L) -> int {
        constexpr int LOG2M = decltype(L)::value;
        if constexpr (MODE != MINOR_PRODUCT && LOG2M > CLUSTER_ROW_LOG2) {
            return launch_minor_cluster<MODE == MINOR_FORWARD, LOG2M>(
                rows, xr, xi, yr, yi, tw, stream);
        } else {
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
        }
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

// The clusters the card holds at once for the forward (inverse 0) or the
// inverse mode at M = 2^log2M, 8192 or 16384. 0: its launches are refused.
int am_minor_clusters(int inverse, int log2M, int* clusters) {
    *clusters = 0;
    if (log2M <= CLUSTER_ROW_LOG2 || !factor_fits(log2M))
        return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg{};
    cudaLaunchAttribute attr[1];
    return with_factor(log2M, [&](auto L) -> int {
        constexpr int LOG2M = decltype(L)::value;
        if constexpr (LOG2M <= CLUSTER_ROW_LOG2) {
            return (int)cudaErrorInvalidValue;
        } else {
            return (int)(inverse ? minor_cluster_config<false, LOG2M>(
                                       &cfg, attr, 0, clusters)
                                 : minor_cluster_config<true, LOG2M>(
                                       &cfg, attr, 0, clusters));
        }
    });
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
