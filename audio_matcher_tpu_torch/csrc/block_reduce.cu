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
// deterministic; (value, lowest column), fminf and fmaxf do not depend on
// the order anyway.
//
// What bounds it on an H100: device-memory bytes. At the batch scan's slab
// it reads 2 x 2.9 GB of planes once and writes 4 x [512, 5504] words; the
// dense mode at the xla_packed scan's slab (8 windows x 8 queries) reads one
// [64, 2.8 M] f32 array, 0.72 GB. The modes differ only in where a row
// starts and in the scale, a template flag, so they share one body.
//
// What the design does about it (ops/cuda_kernels.py's reduce_grid and
// tile_columns mirror the geometry; the CPU tests check them):
//  * A warp walks a run of `run` consecutive tiles of one row. The next
//    tile's float4s are in flight while the current one reduces (a register
//    double buffer), with streaming loads (ld.global.cs): each byte is read
//    once. The wrapper sizes the runs so that the grid holds at least
//    eight full waves of warps on the card: a short last wave of
//    long-lived blocks would leave it part-empty.
//  * Coalesced loads: lane i takes float4 i of each 128-column chunk of the
//    tile, so a warp's load is 512 contiguous bytes. Neighbours across lanes
//    and chunks come by one shuffle each way per chunk; the left neighbour
//    of a tile is carried over from the previous tile, so a run loads only
//    its two outer neighbours separately.
//  * The segment seams are decided once per tile: only column 0 of a tile
//    with tile % group == 0 and the last column of a tile with tile % group
//    == group - 1 are seam columns. The validity masks compare the column's
//    place in the tile, an immediate, with one per-tile bound; a tile that
//    lies wholly below valid_len - 1 skips them.
//  * 32-bit columns and positions (V < 2^31, checked by the wrapper); the
//    row offset L * V is 64-bit.
//
// Each C entry point returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // warps a block
constexpr unsigned FULL = 0xffffffffu;

template <bool PACKED>
__device__ __forceinline__ float scaled(float v, float s) {
    return PACKED ? v * s : v;
}

// The tile's four float4s a lane holds: float4 `lane` of each 128-column
// chunk, streamed past L1.
template <int CH>
__device__ __forceinline__ void load_tile(float4 (&x)[CH], const float* p,
                                          int lane) {
#pragma unroll
    for (int k = 0; k < CH; ++k)
        x[k] = __ldcs(reinterpret_cast<const float4*>(p + 128 * k) + lane);
}

__device__ __forceinline__ float part(const float4& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// One tile at column `base`: the candidate, minimum and maximum of the
// lane's columns. `carry` (lane 31's) is the column before the tile and
// becomes the tile's last column; `after` (lane 0's) is the column after
// it. rv = valid_len - base - 4 * lane: column j = 128 k + 4 lane + e of
// the tile is valid iff 128 k + e < rv, a candidate only below rv - 1.
// FULL_TILE: every column is a valid candidate but for the seams.
template <int CH, bool PACKED, bool FULL_TILE>
__device__ __forceinline__ void reduce_tile(
    const float4 (&x)[CH], float s, float& carry, float after, int lane,
    int base, int rv, bool seam_first, bool seam_last, float& best,
    int& best_pos, float& lo, float& hi) {
#pragma unroll
    for (int k = 0; k < CH; ++k) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = scaled<PACKED>(part(x[k], e), s);
        // lane 31 publishes the column before the chunk, lane 0 the one
        // after it; every other lane its own edge column
        const float next =
            k + 1 < CH ? scaled<PACKED>(x[k + 1].x, s) : after;
        const float left = __shfl_sync(
            FULL, lane == 31 ? carry : v[3], (lane + 31) & 31);
        const float right = __shfl_sync(
            FULL, lane == 0 ? next : v[0], (lane + 1) & 31);
        carry = v[3];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int j = 128 * k + e;  // minus 4 * lane
            const float l = e > 0 ? v[e - 1] : left;
            const float r = e < 3 ? v[e + 1] : right;
            bool cand = FULL_TILE || j < rv - 1;
            if (k == 0 && e == 0) cand = cand && !(seam_first && lane == 0);
            if (k == CH - 1 && e == 3)
                cand = cand && !(seam_last && lane == 31);
            if (cand && v[e] > l && v[e] > r && v[e] > best) {
                best = v[e];
                best_pos = base + 4 * lane + j;
            }
            if (FULL_TILE || j < rv) {
                lo = fminf(lo, v[e]);
                hi = fmaxf(hi, v[e]);
            }
        }
    }
}

// Warp w of the grid takes run r = w mod runs of row L = w / runs: tiles
// [r * run, min(r * run + run, NB)).
template <int PER, bool PACKED>  // columns per lane: block = 32 * PER
__global__ void __launch_bounds__(WARPS * 32)
block_reduce(const float* __restrict__ yr, const float* __restrict__ yi,
             const float* __restrict__ scale,
             const int* __restrict__ valid, float* __restrict__ bv,
             int* __restrict__ bp, float* __restrict__ bmin,
             float* __restrict__ bmax, int rows, int V, int NB, int group,
             int run, int runs) {
    constexpr int BLOCK = 32 * PER;
    constexpr int CH = PER / 4;  // 128-column chunks of a tile
    const int lane = threadIdx.x & 31;
    const long long w = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (w >= (long long)rows * runs) return;  // whole warp leaves together
    const int L = (int)(w / runs);
    const int t0 = (int)(w - (long long)L * runs) * run;
    const int t1 = min(t0 + run, NB);
    const float* plane =
        PACKED ? ((L & 1) ? yi : yr) + (long long)(L >> 1) * V
               : yr + (long long)L * V;
    const float s = PACKED ? scale[L] : 1.0f;
    const int vlen = valid[L];
    // the run's outer neighbours; a column past V reads as the zero pad of
    // the TPU kernel's grid
    float carry = t0 > 0 ? scaled<PACKED>(plane[t0 * BLOCK - 1], s) : 0.0f;
    const float edge =
        t1 * BLOCK < V ? scaled<PACKED>(plane[t1 * BLOCK], s) : 0.0f;

    float4 cur[CH], nxt[CH];
    load_tile(cur, plane + t0 * BLOCK, lane);
    for (int t = t0; t < t1; ++t) {
        const int base = t * BLOCK;
        const bool more = t + 1 < t1;
        if (more) load_tile(nxt, plane + base + BLOCK, lane);
        const float after = more ? scaled<PACKED>(nxt[0].x, s) : edge;
        const int rv = vlen - base - 4 * lane;
        const int in_group = t % group;
        float best = -INFINITY, lo = INFINITY, hi = -INFINITY;
        int best_pos = base + 4 * lane;
        if (vlen - base > BLOCK)  // warp-uniform
            reduce_tile<CH, PACKED, true>(
                cur, s, carry, after, lane, base, rv, in_group == 0,
                in_group == group - 1, best, best_pos, lo, hi);
        else
            reduce_tile<CH, PACKED, false>(
                cur, s, carry, after, lane, base, rv, in_group == 0,
                in_group == group - 1, best, best_pos, lo, hi);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_xor_sync(FULL, best, off);
            const int op = __shfl_xor_sync(FULL, best_pos, off);
            if (ov > best || (ov == best && op < best_pos)) {
                best = ov;
                best_pos = op;
            }
            lo = fminf(lo, __shfl_xor_sync(FULL, lo, off));
            hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, off));
        }
        if (lane == 0) {
            const long long o = (long long)L * NB + t;
            bv[o] = best;
            bp[o] = best_pos;
            bmin[o] = lo;
            bmax[o] = hi;
        }
        if (more) {
#pragma unroll
            for (int k = 0; k < CH; ++k) cur[k] = nxt[k];
        }
    }
}

template <int PER, bool PACKED>
int launch(const float* yr, const float* yi, const float* scale,
           const int* valid, float* bv, int* bp, float* bmin, float* bmax,
           int rows, int V, int group, int run, cudaStream_t stream) {
    const int NB = V / (32 * PER);
    if (NB < 1 || run < 1) return (int)cudaErrorInvalidValue;
    const int runs = (NB + run - 1) / run;
    const long long blocks = ((long long)rows * runs + WARPS - 1) / WARPS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    block_reduce<PER, PACKED><<<(unsigned)blocks, WARPS * 32, 0, stream>>>(
        yr, yi, scale, valid, bv, bp, bmin, bmax, rows, V, NB, group, run,
        runs);
    return (int)cudaGetLastError();
}

template <bool PACKED>
int launch_block(const float* yr, const float* yi, const float* scale,
                 const int* valid, float* bv, int* bp, float* bmin,
                 float* bmax, int rows, int V, int block, int group, int run,
                 cudaStream_t s) {
    switch (block) {
        case 128:
            return launch<4, PACKED>(yr, yi, scale, valid, bv, bp, bmin, bmax,
                                     rows, V, group, run, s);
        case 256:
            return launch<8, PACKED>(yr, yi, scale, valid, bv, bp, bmin, bmax,
                                     rows, V, group, run, s);
        case 512:
            return launch<16, PACKED>(yr, yi, scale, valid, bv, bp, bmin,
                                      bmax, rows, V, group, run, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

int am_block_reduce_packed(const float* yr, const float* yi,
                           const float* scale, const int* valid, float* bv,
                           int* bp, float* bmin, float* bmax, int rows, int V,
                           int block, int group, int run, void* stream) {
    return launch_block<true>(yr, yi, scale, valid, bv, bp, bmin, bmax, rows,
                              V, block, group, run, (cudaStream_t)stream);
}

// The dense form: row L of x, no scale, no de-interleave.
int am_block_reduce(const float* x, const int* valid, float* bv, int* bp,
                    float* bmin, float* bmax, int rows, int V, int block,
                    int group, int run, void* stream) {
    return launch_block<false>(x, nullptr, nullptr, valid, bv, bp, bmin, bmax,
                               rows, V, block, group, run,
                               (cudaStream_t)stream);
}

}  // extern "C"
