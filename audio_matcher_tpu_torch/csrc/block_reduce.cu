// One-pass peak-candidate reduction over correlation rows, for Hopper
// (sm_90a).
//
// Replaces two Pallas TPU kernels of audio_matcher_tpu/ops/pallas_kernels.py
// (both on _reduce_rows):
//   block_reduce<PER, true>  <- local_max_block_reduce_packed
//                               (_block_reduce_packed_kernel)
//   block_reduce<PER, false> <- local_max_block_reduce (_block_reduce_kernel)
// Packed: logical row L is plane yr[L/2] (L even) or yi[L/2] (L odd) times
// scale[L]. Dense: row L of a [rows, V] array, unscaled (the xla_packed
// correlation). For every tile of `block` columns it emits, masked by
// valid[L]: the best strict local maximum (value and global column), the
// tile minimum and the tile maximum.
//
// Contract kept from the TPU kernel, so that peaks._merge_seams gives the
// same answer on both: columns are grouped in segments of group*block; the
// first and last column of each segment are never candidates here (the
// caller re-checks them); ties go to the lowest column, as argmax does, and a
// tile without a candidate reports -inf at its first column. The reduction
// runs in a fixed order with warp shuffles and no atomics, so it is
// deterministic.
//
// What bounds it on an H100: device-memory bytes. At the batch scan's slab it
// reads 2 x 2.9 GB of planes once and writes 4 x [512, 5504] words; the dense
// mode at the xla_packed scan's slab (8 windows x 8 queries) reads one
// [64, 2.8 M] f32 array, 0.72 GB. The modes differ only in where a row
// starts and in the scale, a template flag, so they share one body. One warp
// reduces one tile: each lane loads block/32 consecutive columns as float4,
// takes its neighbours across lanes with shuffles, and only the two tile-edge
// neighbours are fetched separately (cached).
//
// Each C entry point returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;

// Logical row L's values: PACKED reads plane yr[L/2] or yi[L/2] times
// scale[L]; dense reads row L of x (passed as yr) unscaled.
template <bool PACKED>
__device__ __forceinline__ float load_scaled(float v, float s) {
    return PACKED ? v * s : v;
}

template <int PER, bool PACKED>  // columns per lane: block = 32 * PER
__global__ void __launch_bounds__(WARPS * 32)
block_reduce(const float* __restrict__ yr, const float* __restrict__ yi,
             const float* __restrict__ scale,
             const int* __restrict__ valid, float* __restrict__ bv,
             int* __restrict__ bp, float* __restrict__ bmin,
             float* __restrict__ bmax, long long V, int NB, int seg) {
    constexpr int BLOCK = 32 * PER;
    const int lane = threadIdx.x & 31;
    const int tile = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int L = blockIdx.y;
    if (tile >= NB) return;  // whole warp leaves together
    const float* plane =
        PACKED ? ((L & 1) ? yi : yr) + (long long)(L >> 1) * V
               : yr + (long long)L * V;
    const float s = PACKED ? scale[L] : 1.0f;
    const int vlen = valid[L];
    const long long tile_base = (long long)tile * BLOCK;
    const long long col0 = tile_base + lane * PER;

    float x[PER];
#pragma unroll
    for (int k = 0; k < PER; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(plane + col0 + k);
        x[k] = load_scaled<PACKED>(v.x, s);
        x[k + 1] = load_scaled<PACKED>(v.y, s);
        x[k + 2] = load_scaled<PACKED>(v.z, s);
        x[k + 3] = load_scaled<PACKED>(v.w, s);
    }
    // neighbours across lanes; the tile's own edges load their neighbour
    // (a column past V reads as the zero pad of the TPU kernel's grid)
    float left = __shfl_up_sync(0xffffffffu, x[PER - 1], 1);
    float right = __shfl_down_sync(0xffffffffu, x[0], 1);
    if (lane == 0)
        left = tile_base > 0
                   ? load_scaled<PACKED>(plane[tile_base - 1], s) : 0.0f;
    if (lane == 31)
        right = tile_base + BLOCK < V
                    ? load_scaled<PACKED>(plane[tile_base + BLOCK], s) : 0.0f;

    float best = -INFINITY;
    long long best_pos = col0;
    float lo = INFINITY, hi = -INFINITY;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const long long col = col0 + k;
        const bool colvalid = col < vlen;
        const float l = k > 0 ? x[k - 1] : left;
        const float r = k < PER - 1 ? x[k + 1] : right;
        const long long in_seg = col % seg;
        const bool interior = col >= 1 && col <= (long long)vlen - 2 &&
                              in_seg != 0 && in_seg != seg - 1;
        const bool peak = interior && colvalid && x[k] > l && x[k] > r;
        if (peak && x[k] > best) {
            best = x[k];
            best_pos = col;
        }
        if (colvalid) {
            lo = fminf(lo, x[k]);
            hi = fmaxf(hi, x[k]);
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, off);
        const long long op = __shfl_xor_sync(0xffffffffu, best_pos, off);
        if (ov > best || (ov == best && op < best_pos)) {
            best = ov;
            best_pos = op;
        }
        lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0) {
        const long long o = (long long)L * NB + tile;
        bv[o] = best;
        bp[o] = (int)best_pos;
        bmin[o] = lo;
        bmax[o] = hi;
    }
}

template <int PER, bool PACKED>
int launch(const float* yr, const float* yi, const float* scale,
           const int* valid, float* bv, int* bp, float* bmin, float* bmax,
           int rows, long long V, int group, cudaStream_t stream) {
    const int NB = (int)(V / (32 * PER));
    dim3 grid((NB + WARPS - 1) / WARPS, rows);
    block_reduce<PER, PACKED><<<grid, WARPS * 32, 0, stream>>>(
        yr, yi, scale, valid, bv, bp, bmin, bmax, V, NB, group * 32 * PER);
    return (int)cudaGetLastError();
}

template <bool PACKED>
int launch_block(const float* yr, const float* yi, const float* scale,
                 const int* valid, float* bv, int* bp, float* bmin,
                 float* bmax, int rows, long long V, int block, int group,
                 cudaStream_t s) {
    switch (block) {
        case 128:
            return launch<4, PACKED>(yr, yi, scale, valid, bv, bp, bmin, bmax,
                                     rows, V, group, s);
        case 256:
            return launch<8, PACKED>(yr, yi, scale, valid, bv, bp, bmin, bmax,
                                     rows, V, group, s);
        case 512:
            return launch<16, PACKED>(yr, yi, scale, valid, bv, bp, bmin,
                                      bmax, rows, V, group, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

int am_block_reduce_packed(const float* yr, const float* yi,
                           const float* scale, const int* valid, float* bv,
                           int* bp, float* bmin, float* bmax, int rows,
                           long long V, int block, int group, void* stream) {
    return launch_block<true>(yr, yi, scale, valid, bv, bp, bmin, bmax, rows,
                              V, block, group, (cudaStream_t)stream);
}

// The dense [rows, V] form: row L of x, no scale, no de-interleave.
int am_block_reduce(const float* x, const int* valid, float* bv, int* bp,
                    float* bmin, float* bmax, int rows, long long V,
                    int block, int group, void* stream) {
    return launch_block<false>(x, nullptr, nullptr, valid, bv, bp, bmin, bmax,
                               rows, V, block, group, (cudaStream_t)stream);
}

}  // extern "C"
