// The peak rounds of the single-read picker in one launch, for Hopper
// (sm_90a): after the block reduction (block_reduce.cu), each logical row's
// seam merge, its n_peaks suppression rounds with the exact rescan of the
// two partly suppressed edge tiles, and the prominence of every pick.
//
// Replaces no TPU kernel. The JAX package runs these stages as plain jnp
// (audio_matcher_tpu/ops/peaks.py, pick_peaks_pallas_packed after
// local_max_block_reduce_packed), and the port ran them as torch ops
// (ops/peaks.py, _peak_rounds_plain, kept as the plain version). That chain
// is some 400 kernels a slab at n_peaks = 2, each a few microseconds over
// [rows, NB] block arrays or a tile of 514 columns; its arithmetic is a
// handful of compares. This kernel was added because the chain was bound by
// launches, not by work.
//
// What bounds it on an H100: latency. A row reads its block arrays (16 bytes
// a tile) and a few tiles of its plane; at the cells' slabs (NB = 5248 tiles,
// 8 or 32 rows) that is under 3 MB, 1 us at the memory rate. What is left is
// the chain of dependent steps of one row: every round waits for the last.
//
// What the design does about it (ops/cuda_kernels.py's rounds_layout is the
// layout's choice; tests/test_torch_rounds_plan.py writes the index
// arithmetic out again and checks it against the plain version on the CPU,
// and the GPU tests hold the kernel to it bit for bit):
//  * One CTA per logical row: row L reads plane yr[L/2] (L even) or yi[L/2]
//    (L odd) times scale[L] (packed) or row L of a dense [rows, V] array.
//    Rows are independent, so the rounds never leave the CTA.
//  * Where the row's bv/bp fit (8 bytes a tile with the picks' table, up to
//    ROUNDS_SMEM), they are copied to shared memory and every round works
//    there, 512 threads. Past that (fft_len 2^25-2^28: NB up to ~2.7e5) the
//    rounds work in place on the block reduction's outputs in device memory,
//    which the L2 holds, with 1024 threads. The layout follows NB; the
//    wrapper passes the choice, the launch refuses a shared one too large.
//    At the cells' rows (5248 tiles, 8 or 32 rows, 2 slots) the shared
//    layout takes 15.4-15.9 us a launch and the in-place one 23.9-24.3 us;
//    at 64 slots 654 against 1053-1059 us (an H100 at 700 W).
//  * A round is a CTA-wide argmax over the row's tiles (ties to the lowest
//    tile, as torch.argmax), a store of -inf into the tiles wholly inside
//    the suppressed interval, and a rescan of its two edge tiles from the
//    plane: one column a thread (block <= 512 <= threads), each tested
//    against every picked slot, ties to the lowest column. A round that
//    finds no finite tile ends the rounds: nothing changes after it, so the
//    remaining slots repeat its (position, -inf).
//  * The prominence of each slot is the plain version's walk in three
//    CTA-wide reductions: own block and nearest higher block on both sides;
//    then the minima inside the spans and the far block's crossing column;
//    then the far block's minimum past it.
//
// Results are bit-identical to the plain version, exhausted slots included:
// every operation is a compare, a select, one f32 product (__fmul_rn, never
// contracted into an FMA) or one f32 subtraction (__fsub_rn). The planes
// must be finite (the correlation's are); fminf and fmaxf ignore a NaN where
// torch's reductions propagate it.
//
// The C entry point returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SENTINEL = -(1 << 30);  // a picked slot that excludes nothing
constexpr int MAX_BLOCK = 512;        // tile width: a column a thread
constexpr int MAX_PEAKS = 4096;
constexpr int ROUNDS_SMEM = 200 * 1024;  // dynamic shared bytes, at most
constexpr int SHARED_THREADS = 512;
constexpr int GLOBAL_THREADS = 1024;

template <int THREADS>
struct Scratch {  // one slot a warp for the CTA-wide reductions
    float f[THREADS / 32][4];
    int i[THREADS / 32][4];
    float av[THREADS / 32];
    int ai[THREADS / 32];
};

// A logical row's samples, scaled as the plain version scales them.
template <bool PACKED>
struct Row {
    const float* p;
    float s;
    __device__ __forceinline__ float operator()(int c) const {
        const float x = __ldg(p + c);
        return PACKED ? __fmul_rn(x, s) : x;
    }
};

__device__ __forceinline__ long long floor_div(long long a, long long b) {
    return a >= 0 ? a / b : -((-a + b - 1) / b);  // b > 0
}

__device__ __forceinline__ long long ceil_div(long long a, long long b) {
    return -floor_div(-a, b);
}

// (v, i) takes (ov, oi) if it is larger, or equal at a lower index.
__device__ __forceinline__ void arg_better(float& v, int& i, float ov,
                                           int oi) {
    if (ov > v || (ov == v && oi < i)) {
        v = ov;
        i = oi;
    }
}

// CTA-wide argmax, ties to the lowest index; every thread gets the result.
template <int THREADS>
__device__ __forceinline__ void block_argmax(float& v, int& i,
                                             Scratch<THREADS>& sc) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        arg_better(v, i, __shfl_xor_sync(FULL, v, off),
                   __shfl_xor_sync(FULL, i, off));
    const int w = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        sc.av[w] = v;
        sc.ai[w] = i;
    }
    __syncthreads();
    v = sc.av[0];
    i = sc.ai[0];
#pragma unroll
    for (int k = 1; k < THREADS / 32; ++k) arg_better(v, i, sc.av[k], sc.ai[k]);
    __syncthreads();
}

// CTA-wide minima of KF floats and KI ints; every thread gets the results.
template <int THREADS, int KF, int KI>
__device__ __forceinline__ void block_min(float (&f)[KF], int (&n)[KI],
                                          Scratch<THREADS>& sc) {
    static_assert(KF <= 4 && KI <= 4, "four of each a reduction");
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int k = 0; k < KF; ++k)
            f[k] = fminf(f[k], __shfl_xor_sync(FULL, f[k], off));
#pragma unroll
        for (int k = 0; k < KI; ++k)
            n[k] = min(n[k], __shfl_xor_sync(FULL, n[k], off));
    }
    const int w = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
        for (int k = 0; k < KF; ++k) sc.f[w][k] = f[k];
#pragma unroll
        for (int k = 0; k < KI; ++k) sc.i[w][k] = n[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KF; ++k) {
        f[k] = sc.f[0][k];
        for (int j = 1; j < THREADS / 32; ++j) f[k] = fminf(f[k], sc.f[j][k]);
    }
#pragma unroll
    for (int k = 0; k < KI; ++k) {
        n[k] = sc.i[0][k];
        for (int j = 1; j < THREADS / 32; ++j) n[k] = min(n[k], sc.i[j][k]);
    }
    __syncthreads();
}

// The best surviving strict local maximum of tile e, every picked interval
// |col - p_j| < d excluded (picks 0..r real, the rest sentinels): the
// plain version's window [p0, p0 + width) and its argmax over the inner
// columns, -inf and the window's first inner column when none survives.
template <int THREADS, bool PACKED>
__device__ __forceinline__ void rescan(const Row<PACKED>& row, int vl, int V,
                                       int block, long long e,
                                       const int* picked, int r, int S,
                                       long long d, Scratch<THREADS>& sc,
                                       float& nv, int& npos) {
    const int start = (int)e * block;
    const int width = min(block + 2, V);
    const int p0 = min(max(start - 1, 0), max(V - width, 0));
    float v = -INFINITY;
    int i = INT_MAX;
    if ((int)threadIdx.x < width - 2) {
        const int col = p0 + 1 + (int)threadIdx.x;
        const float c = row(col);
        bool pk = c > row(col - 1) && c > row(col + 1) && col >= 1 &&
                  col <= vl - 2 && col >= start && col < start + block;
        if (pk) {
            for (int j = 0; j <= r; ++j)
                pk = pk && llabs((long long)col - picked[j]) >= d;
            if (r + 1 < S) pk = pk && (long long)col - SENTINEL >= d;
        }
        v = pk ? c : -INFINITY;
        i = (int)threadIdx.x;
    }
    block_argmax<THREADS>(v, i, sc);
    nv = v;
    npos = p0 + 1 + i;
}

template <int THREADS, bool PACKED, bool SHARED>
__global__ void __launch_bounds__(THREADS)
peak_rounds(const float* __restrict__ yr, const float* __restrict__ yi,
            const float* __restrict__ scale, const int* __restrict__ valid,
            float* bv_g, int* bp_g, const float* __restrict__ bmin_g,
            const float* __restrict__ bmax_g, int* __restrict__ pos_out,
            float* __restrict__ h_out, float* __restrict__ prom_out, int V,
            int NB, int block, int group, long long d, int S) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ Scratch<THREADS> sc;
    const int tid = threadIdx.x;
    const int L = blockIdx.x;
    Row<PACKED> row;
    row.p = PACKED ? ((L & 1) ? yi : yr) + (long long)(L >> 1) * V
                   : yr + (long long)L * V;
    row.s = PACKED ? scale[L] : 1.0f;
    const int vl = valid[L];
    const long long base = (long long)L * NB;
    const float* bmin = bmin_g + base;
    const float* bmax = bmax_g + base;
    int* picked = reinterpret_cast<int*>(smem);
    int* spos = picked + S;
    float* sh = reinterpret_cast<float*>(spos + S);
    float* bv;
    int* bp;
    if (SHARED) {
        bv = sh + S;
        bp = reinterpret_cast<int*>(bv + NB);
        for (int t = tid; t < NB; t += THREADS) {
            bv[t] = bv_g[base + t];
            bp[t] = bp_g[base + t];
        }
    } else {
        bv = bv_g + base;
        bp = bp_g + base;
    }
    for (int j = tid; j < S; j += THREADS) picked[j] = SENTINEL;
    __syncthreads();

    // seam merge: the reduction leaves the last column of tile j - 1 and the
    // first of tile j blind at each seam j = group, 2 group, ... < NB; the
    // last column wins only when strictly higher, the first also on
    // equality. Every seam column updates its own tile.
    const int seams = (NB - 1) / group;
    for (int k = tid; k < 2 * seams; k += THREADS) {
        const bool strict = k < seams;
        const int p = group * ((strict ? k : k - seams) + 1) * block -
                      (strict ? 1 : 0);
        const float x0 = row(p);
        const bool pk = x0 > row(p - 1) && x0 > row(p + 1) && p >= 1 &&
                        p <= vl - 2;
        const float h = pk ? x0 : -INFINITY;
        const int t = p / block;
        const float cur = bv[t];
        if (strict ? h > cur : (h >= cur && isfinite(h))) {
            bv[t] = h;
            bp[t] = p;
        }
    }
    __syncthreads();

    // the suppression rounds
    for (int r = 0; r < S; ++r) {
        float h = -INFINITY;
        int k = INT_MAX;
#pragma unroll 4
        for (int t = tid; t < NB; t += THREADS) arg_better(h, k, bv[t], t);
        block_argmax<THREADS>(h, k, sc);
        const int pos = bp[k];
        if (!isfinite(h)) {  // uniform: the rows' state stays as it is
            for (int q = r + tid; q < S; q += THREADS) {
                spos[q] = pos;
                sh[q] = h;
            }
            break;
        }
        if (tid == 0) {
            picked[r] = pos;
            spos[r] = pos;
            sh[r] = h;
        }
        const long long lo = (long long)pos - d + 1;
        const long long hi = (long long)pos + d - 1;
        const long long f0 = max(ceil_div(lo, block), 0LL);
        const long long f1 = min(floor_div(hi + 1, block) - 1, (long long)NB - 1);
        for (long long t = f0 + tid; t <= f1; t += THREADS) bv[t] = -INFINITY;
        __syncthreads();
        const long long e0 = floor_div(lo, block);
        const long long e1 = floor_div(hi, block);
        for (int side = 0; side < 2; ++side) {
            const long long e = side ? e1 : e0;
            if (e < 0 || e >= NB || (side && e1 == e0)) continue;
            float nv;
            int npos;
            rescan<THREADS, PACKED>(row, vl, V, block, e, picked, r, S, d, sc,
                                    nv, npos);
            if (tid == 0) {
                bv[e] = nv;
                bp[e] = npos;
            }
        }
        __syncthreads();
    }
    __syncthreads();

    // prominence of each slot
    const bool has = tid < block;  // the thread's column of a tile
    for (int q = 0; q < S; ++q) {
        const float h = sh[q];
        const int pos = max(spos[q], 0);
        const int pb = pos / block;
        const int rr = pos % block;
        const int c = tid;
        float o_min = INFINITY, o_max = -INFINITY;
        if (has) {
            const int col = min(max(pb, 0), NB - 1) * block + c;
            if (col < vl) o_min = o_max = row(col);
        }
        // own block and the nearest higher block, both sides; j_in and
        // j_blk of the left side are maxima, kept negated as minima
        float f[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
        int n[4] = {1, block, 1, NB};
        if (has) {
            if (c < rr && o_max > h) n[0] = -c;
            if (c > rr && o_max > h) n[1] = c;
            if (c <= rr) f[0] = o_min;
            if (c >= rr) f[1] = o_min;
        }
        for (int b = tid; b < NB; b += THREADS) {
            if (b < pb) {
                f[2] = fminf(f[2], bmin[b]);
                if (bmax[b] > h) n[2] = min(n[2], -b);
            } else if (b > pb) {
                f[3] = fminf(f[3], bmin[b]);
                if (bmax[b] > h) n[3] = min(n[3], b);
            }
        }
        block_min<THREADS>(f, n, sc);
        const int jin_l = -n[0], jin_r = n[1], jblk_l = -n[2], jblk_r = n[3];
        const float own_l = f[0], own_r = f[1], edge_l = f[2], edge_r = f[3];

        // the spans' minima and each far block's crossing column
        float xl_min = INFINITY, xl_max = -INFINITY;
        float xr_min = INFINITY, xr_max = -INFINITY;
        if (has) {
            const int cl = min(max(jblk_l, 0), NB - 1) * block + c;
            const int cr = min(max(jblk_r, 0), NB - 1) * block + c;
            if (cl < vl) xl_min = xl_max = row(cl);
            if (cr < vl) xr_min = xr_max = row(cr);
        }
        float g[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
        int m[2] = {1, block};
        if (has) {
            if (c > jin_l && c <= rr) g[0] = o_min;
            if (c < jin_r && c >= rr) g[1] = o_min;
            if (xl_max > h) m[0] = -c;
            if (xr_max > h) m[1] = c;
        }
        for (int b = jblk_l + 1 + tid; b < pb; b += THREADS)
            g[2] = fminf(g[2], bmin[b]);
        for (int b = pb + 1 + tid; b < jblk_r; b += THREADS)
            g[3] = fminf(g[3], bmin[b]);
        block_min<THREADS>(g, m, sc);
        const int jfar_l = -m[0], jfar_r = m[1];

        // the far blocks' minima past their crossing columns
        float u[2] = {INFINITY, INFINITY};
        int none[1] = {0};
        if (has) {
            if (c > jfar_l) u[0] = xl_min;
            if (c < jfar_r) u[1] = xr_min;
        }
        block_min<THREADS>(u, none, sc);
        const float left =
            jin_l >= 0 ? g[0]
            : jblk_l >= 0 ? fminf(fminf(u[0], g[2]), own_l)
                          : fminf(edge_l, own_l);
        const float right =
            jin_r < block ? g[1]
            : jblk_r < NB ? fminf(fminf(u[1], g[3]), own_r)
                          : fminf(edge_r, own_r);
        if (tid == 0) {
            const long long o = (long long)L * S + q;
            pos_out[o] = spos[q];
            h_out[o] = h;
            prom_out[o] = __fsub_rn(h, fmaxf(left, right));
        }
    }
}

template <int THREADS, bool PACKED, bool SHARED>
int launch(const float* yr, const float* yi, const float* scale,
           const int* valid, float* bv, int* bp, const float* bmin,
           const float* bmax, int* pos, float* height, float* prom, int rows,
           int V, int NB, int block, int group, long long d, int S,
           size_t bytes, cudaStream_t stream) {
    auto kernel = peak_rounds<THREADS, PACKED, SHARED>;
    // idempotent, so several host threads may launch side by side
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ROUNDS_SMEM);
    if (err != cudaSuccess) return (int)err;
    kernel<<<rows, THREADS, bytes, stream>>>(
        yr, yi, scale, valid, bv, bp, bmin, bmax, pos, height, prom, V, NB,
        block, group, d, S);
    return (int)cudaGetLastError();
}

template <bool PACKED>
int launch_layout(const float* yr, const float* yi, const float* scale,
                  const int* valid, float* bv, int* bp, const float* bmin,
                  const float* bmax, int* pos, float* height, float* prom,
                  int rows, int V, int block, int group, long long d, int S,
                  int shared, cudaStream_t stream) {
    const int NB = block > 0 ? V / block : 0;
    if (rows < 1 || block < 1 || block > MAX_BLOCK || NB < 1 ||
        (long long)NB * block != V || group < 2 || d < 1 || S < 1 ||
        S > MAX_PEAKS)
        return (int)cudaErrorInvalidValue;
    const size_t table = 12 * (size_t)S;  // picked, positions, heights
    if (shared) {
        const size_t bytes = table + 8 * (size_t)NB;
        if (bytes > (size_t)ROUNDS_SMEM) return (int)cudaErrorInvalidValue;
        return launch<SHARED_THREADS, PACKED, true>(
            yr, yi, scale, valid, bv, bp, bmin, bmax, pos, height, prom, rows,
            V, NB, block, group, d, S, bytes, stream);
    }
    return launch<GLOBAL_THREADS, PACKED, false>(
        yr, yi, scale, valid, bv, bp, bmin, bmax, pos, height, prom, rows, V,
        NB, block, group, d, S, table, stream);
}

}  // namespace

extern "C" {

// Packed: yr, yi [rows / 2, V] and scale [rows]. Dense (packed = 0): yr is
// the [rows, V] array, yi and scale are unused. bv, bp [rows, V / block] are
// the reduction's candidates and are overwritten; bmin, bmax are read.
int am_peak_rounds(const float* yr, const float* yi, const float* scale,
                   const int* valid, float* bv, int* bp, const float* bmin,
                   const float* bmax, int* pos, float* height, float* prom,
                   int rows, int V, int block, int group, long long distance,
                   int n_peaks, int packed, int shared, void* stream) {
    if (packed)
        return launch_layout<true>(yr, yi, scale, valid, bv, bp, bmin, bmax,
                                   pos, height, prom, rows, V, block, group,
                                   distance, n_peaks, shared,
                                   (cudaStream_t)stream);
    return launch_layout<false>(yr, nullptr, nullptr, valid, bv, bp, bmin,
                                bmax, pos, height, prom, rows, V, block,
                                group, distance, n_peaks, shared,
                                (cudaStream_t)stream);
}

}  // extern "C"
