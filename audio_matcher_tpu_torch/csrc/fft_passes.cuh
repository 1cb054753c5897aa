// The core the two FFT-pass kernels share (fft_minor.cu: minor_pass,
// fft_major.cu: major_pass), for Hopper (sm_90a).
//
// What is computed. A transform of length n = A*M is viewed as [A, M],
// a-major. The forward major pass runs a radix-2 DIF over the strided A axis
// of every column c (natural input, bit-reversed output) and then multiplies
// physical row r by the cross twiddle W_n^{brev_A(r)*c}. The forward minor
// pass runs the same DIF along each contiguous M row. Together they leave the
// scrambled spectrum Y[r, q] = X[brev_A(r) + A*brev_M(q)]; nothing here ever
// reorders it. The inverse passes undo the stages in reverse order with
// conjugate twiddles (bit-reversed input, natural output, unscaled).
//
// Stage groups in registers. A thread holds PTS = 16 points of a line (a
// row in the minor pass, a column in the major pass): the points whose
// indices vary over one 4-bit window [w, w + 4) of the index. It runs the
// 3 or 4 radix-2 stages whose bits lie in that window in registers, with
// the butterflies and twiddle values of the plain radix-2 chain, so the
// bit-reversed order and the rounding stay. Shared memory carries only the
// exchanges between groups: two at L = 2048 (4 + 4 + 3 stages) instead of
// eleven round trips. The groups of each L are compile-time constants
// (Plan, the same grouping as ops/fft_plan.py's stage_groups, which the CPU
// tests check against the plain transforms): every kernel is instantiated
// per factor, so window offsets, twiddle offsets and exchange addresses
// fold into immediates and the 16 points keep their registers.
//
// Twiddles from a table. W_{2m}^j of every stage sits at entry m + j of a
// per-L table that twiddle_table (fft_minor.cu) builds once per device and
// L with sincospif of the exact rational -j/m, the value the chain used. A
// warp's reads of it are consecutive entries, through the read-only path.
//
// The exchange tiles are laid out so that no exchange has a bank conflict
// (MinorTile, MajorTile; ops/fft_plan.py mirrors both and a CPU test counts
// the conflicts). There is no fast-math and no tensor-core arithmetic:
// every butterfly runs in full FP32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int PTS = 16;  // points a thread holds
constexpr int LOG2_PTS = 4;
constexpr int MIN_LOG2_FACTOR = 7;
constexpr int MAX_LOG2_FACTOR = 14;  // A, M <= 16384: n <= 2^28

bool factor_fits(int log2L) {
    return log2L >= MIN_LOG2_FACTOR && log2L <= MAX_LOG2_FACTOR;
}

// f(std::integral_constant<int, log2L>) for a factor the passes take.
template <class F>
int with_factor(int log2L, F&& f) {
    switch (log2L) {
        case 7: return f(std::integral_constant<int, 7>{});
        case 8: return f(std::integral_constant<int, 8>{});
        case 9: return f(std::integral_constant<int, 9>{});
        case 10: return f(std::integral_constant<int, 10>{});
        case 11: return f(std::integral_constant<int, 11>{});
        case 12: return f(std::integral_constant<int, 12>{});
        case 13: return f(std::integral_constant<int, 13>{});
        case 14: return f(std::integral_constant<int, 14>{});
        default: return (int)cudaErrorInvalidValue;
    }
}

__device__ __forceinline__ int brev_bits(int x, int bits) {
    return (int)(__brev((unsigned)x) >> (32 - bits));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// exp(sign * 2*pi*i*k/n) for an integer k < n. Up to n = 2^24 (WIDE
// false) every k is exact in f32: one sincospif. Above (WIDE, n <= 2^28),
// k = hi * 2^12 + lo with hi < 2^16 and lo < 2^12, each exact in f32 and
// exact again after its power-of-two scale: two sincospif and one complex
// product (ops/fft_plan.py's cross_root_plain). WIDE is a compile-time
// choice, so that the kernels of n <= 2^24 keep their one call.
template <bool WIDE>
__device__ __forceinline__ float2 root(int k, int log2n, float sign) {
    float s, c;
    if constexpr (!WIDE) {
        sincospif(sign * ldexpf((float)k, 1 - log2n), &s, &c);
        return make_float2(c, s);
    }
    float s0, c0;
    sincospif(sign * ldexpf((float)(k >> 12), 13 - log2n), &s, &c);
    sincospif(sign * ldexpf((float)(k & 4095), 1 - log2n), &s0, &c0);
    return cmul(make_float2(c, s), make_float2(c0, s0));
}

// An opaque copy of x: what is computed from it is computed again where it
// is needed instead of being held in a register across the stages, where
// a thread of a 1024-thread block has 64 for its 32 points and the rest.
__device__ __forceinline__ int opaque(int x) {
    asm volatile("" : "+r"(x));
    return x;
}

// Index in its line of register r of thread u when the thread holds window
// [w, w + 4): r fills the window, u the other bits in order.
__device__ __forceinline__ int position(int u, int r, int w) {
    return (u & ((1 << w) - 1)) | ((u >> w) << (w + LOG2_PTS)) | (r << w);
}

// The stage groups of a line of 2^B points, top bits first: group g holds
// index bits [w(g), w(g) + 4) in a thread's registers and runs the stages
// on register bits qlo(g) .. qlo(g) + k(g) - 1. k is 4, then 3 for the
// last groups; a group of 3 takes the next bit up into its window, or the
// next one down at the top of the index.
#define AM_CONST __host__ __device__ static constexpr
template <int B>
struct Plan {
    static constexpr int NG = (B + LOG2_PTS - 1) / LOG2_PTS;
    static constexpr int FOURS = B - 3 * NG;
    AM_CONST int k(int g) { return g < FOURS ? 4 : 3; }
    AM_CONST int hi(int g) { return g == 0 ? B : hi(g - 1) - k(g - 1); }
    AM_CONST int lo(int g) { return hi(g) - k(g); }
    AM_CONST int w(int g) {
        return k(g) == LOG2_PTS || lo(g) + k(g) < B ? lo(g) : lo(g) - 1;
    }
    AM_CONST int qlo(int g) { return lo(g) - w(g); }
};
#undef AM_CONST

// One radix-2 butterfly on registers r0, r1 with the stage twiddle w:
// forward DIF (a + b, (a - b) w), inverse (a + b conj(w), a - b conj(w)).
// W = 1 and W = -i (the twiddles of the two lowest stages, exactly (1, 0)
// and (0, -1) in the table) skip the products, which are exact there.
enum Twiddle { TW_ANY, TW_ONE, TW_MINUS_I };
template <bool FORWARD, int KIND>
__device__ __forceinline__ void butterfly(float (&xr)[PTS], float (&xi)[PTS],
                                          int r0, int r1, float2 w) {
    const float ar = xr[r0], ai = xi[r0];
    const float br = xr[r1], bi = xi[r1];
    if (FORWARD) {
        const float dr = ar - br, di = ai - bi;
        xr[r0] = ar + br;
        xi[r0] = ai + bi;
        xr[r1] = KIND == TW_ONE ? dr : KIND == TW_MINUS_I ? di
                                     : dr * w.x - di * w.y;
        xi[r1] = KIND == TW_ONE ? di : KIND == TW_MINUS_I ? -dr
                                     : dr * w.y + di * w.x;
    } else {
        const float bwr = KIND == TW_ONE ? br : KIND == TW_MINUS_I ? -bi
                                         : br * w.x + bi * w.y;
        const float bwi = KIND == TW_ONE ? bi : KIND == TW_MINUS_I ? br
                                         : bi * w.x - br * w.y;
        xr[r0] = ar + bwr;
        xi[r0] = ai + bwi;
        xr[r1] = ar - bwr;
        xi[r1] = ai - bwi;
    }
}

// A stage twiddle, through the read-only path. The load is volatile, and
// run_group fences each stage, so that it stays in the stage that needs
// it: hoisted out of a loop over strips, or to the top of a group, the
// twiddles would take up to 30 registers of a thread's 64 beside its 32
// points.
__device__ __forceinline__ float2 load_twiddle(const float2* p) {
    float2 v;
    asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];"
                 : "=f"(v.x), "=f"(v.y)
                 : "l"(p));
    return v;
}

// The radix-2 stages of one group on the thread's registers. FORWARD: DIF,
// the group's top bit first. Inverse: bottom bit first, conjugate twiddles.
// The pair at register bit q is (r0, r0 | 2^q); its lower index i0 has
// j = i0 mod 2^p at bit p = W + q, so the twiddle W_{2^{p+1}}^j sits at
// tw[2^p + (u mod 2^W) + ((r0 mod 2^q) << W)]. Stage p = 0 (W_2^0 = 1)
// and p = 1 (W_4^0 = 1, W_4^1 = -i) read no twiddle.
template <bool FORWARD, int W, int QLO, int K>
__device__ __forceinline__ void run_group(float (&xr)[PTS], float (&xi)[PTS],
                                          int u,
                                          const float2* __restrict__ tw) {
    const int ulo = u & ((1 << W) - 1);
    const float2 one = make_float2(1.0f, 0.0f);
#pragma unroll
    for (int s = 0; s < LOG2_PTS; ++s) {
        const int q = FORWARD ? LOG2_PTS - 1 - s : s;
        if (q < QLO || q >= QLO + K) continue;
        asm volatile("" ::: "memory");  // this stage's loads stay in it
        const int half = 1 << q;
        if (q < 2 && W == 0) {  // stage p = q < 2
#pragma unroll
            for (int r0 = 0; r0 < PTS; r0 += 2 * half) {
                butterfly<FORWARD, TW_ONE>(xr, xi, r0, r0 | half, one);
                if (q == 1)
                    butterfly<FORWARD, TW_MINUS_I>(xr, xi, r0 + 1,
                                                   (r0 + 1) | half, one);
            }
            continue;
        }
        const float2* twp = tw + (1 << (W + q)) + ulo;
#pragma unroll
        for (int t = 0; t < half; ++t) {  // the pairs with r0 mod 2^q = t
            const float2 w = load_twiddle(twp + (t << W));
#pragma unroll
            for (int r0 = t; r0 < PTS; r0 += 2 * half)
                butterfly<FORWARD, TW_ANY>(xr, xi, r0, r0 | half, w);
        }
    }
}

// The exchange tiles map point r of a thread that holds window [w, w + 4)
// of its line (index position(u, r, w)) to a word of a plane. The index
// splits into the thread's base and r << w, which share no bit, and both
// maps are linear over such a split, so a window is the base word and one
// step per bit of r (immediates: w is a constant of the plan).
// The minor pass's tile: point i of block line `line` at word g = line*M
// + i with bits 5-8 of g XORed into its low five bits.
__device__ __forceinline__ int minor_swizzle(int g) {
    return g ^ (((g >> 5) & 1) | (((g >> 6) & 1) << 1) |
                (((g >> 7) & 1) << 3) | (((g >> 8) & 1) * 20));
}
struct MinorTile {
    int base;
    __device__ __forceinline__ int at(int i) const {
        return minor_swizzle(base + i);
    }
    __device__ __forceinline__ int word(int u, int w, int r) const {
        int a = at(position(u, 0, w));
#pragma unroll
        for (int q = 0; q < LOG2_PTS; ++q)
            if (r >> q & 1) a ^= minor_swizzle(1 << (w + q));
        return a;
    }
};
// The major pass's tile: rows of C = 2^LOG2C words, one padding row per 16.
// Its steps are additions of immediates, so a window's 16 words cost one
// base register. At C = 1 (one line: A = 16384, and the product mode's one
// row of 16384) the two halves of a warp's 32 consecutive points meet in
// one bank once (words 0 and 32): a 2-way conflict where a window holds
// the low five index bits, the price of immediates (the minor tile's XOR
// swizzle, conflict-free, takes a register a word, and a thread of 1024
// has 64).
template <int LOG2C>
struct MajorTile {
    int col;
    __device__ __forceinline__ int at(int i) const {
        return ((i + (i >> 4)) << LOG2C) + col;
    }
    __device__ __forceinline__ int word(int u, int w, int r) const {
        int a = at(position(u, 0, w));
#pragma unroll
        for (int q = 0; q < LOG2_PTS; ++q)
            if (r >> q & 1)
                a += ((1 << (w + q)) + ((1 << (w + q)) >> 4)) << LOG2C;
        return a;
    }
};

// One plane of the block's points moves from windows W_FROM to windows
// W_TO (a barrier first: the previous reads of the tile are done).
template <int W_FROM, int W_TO, class Tile>
__device__ __forceinline__ void exchange_plane(float (&x)[PTS], float* s,
                                               Tile tile, int u) {
    __syncthreads();
#pragma unroll
    for (int r = 0; r < PTS; ++r) s[tile.word(u, W_FROM, r)] = x[r];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < PTS; ++r) x[r] = s[tile.word(u, W_TO, r)];
}

// Both planes: side by side in the tiles sr and si (TWO), or one after
// the other through the one tile sr.
template <bool TWO, int W_FROM, int W_TO, class Tile>
__device__ __forceinline__ void exchange(float (&xr)[PTS], float (&xi)[PTS],
                                         float* sr, float* si, Tile tile,
                                         int u) {
    if (!TWO) {
        exchange_plane<W_FROM, W_TO>(xr, sr, tile, u);
        exchange_plane<W_FROM, W_TO>(xi, sr, tile, u);
        return;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < PTS; ++r) {
        const int a = tile.word(u, W_FROM, r);
        sr[a] = xr[r];
        si[a] = xi[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < PTS; ++r) {
        const int a = tile.word(u, W_TO, r);
        xr[r] = sr[a];
        xi[r] = si[a];
    }
}

// Every group of the plan of a line of 2^B points, steps S .. E - 1, with
// the exchanges between them: forward from the top window [B-4, B) down to
// [0, 4), inverse from [0, 4) up. The points come in and go out in
// registers, at the first and the last group's window.
template <bool FORWARD, bool TWO, int B, int S = 0, int E = Plan<B>::NG,
          class Tile>
__device__ __forceinline__ void transform(float (&xr)[PTS], float (&xi)[PTS],
                                          float* sr, float* si, Tile tile,
                                          int u,
                                          const float2* __restrict__ tw) {
    using P = Plan<B>;
    constexpr int G = FORWARD ? S : P::NG - 1 - S;
    if constexpr (S > 0) {
        constexpr int F = FORWARD ? G - 1 : G + 1;  // the group before
        exchange<TWO, P::w(F), P::w(G)>(xr, xi, sr, si, tile, u);
    }
    run_group<FORWARD, P::w(G), P::qlo(G), P::k(G)>(xr, xi, u, tw);
    if constexpr (S + 1 < E)
        transform<FORWARD, TWO, B, S + 1, E>(xr, xi, sr, si, tile, u, tw);
}

// cp.async of g bytes, global -> shared, with a 128-byte L2 prefetch (16
// bytes past L1).
__device__ __forceinline__ void cp_async(void* dst, const void* src, int g) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if (g == 16)
        asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n"
                     :: "r"(d), "l"(src) : "memory");
    else if (g == 8)
        asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], 8;\n"
                     :: "r"(d), "l"(src) : "memory");
    else
        asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], 4;\n"
                     :: "r"(d), "l"(src) : "memory");
}

// ------------------------------------------------ thread-block clusters
// What the passes on clusters (fft_major.cu's cluster_pass, fft_minor.cu's
// minor_cluster_pass) share.
// The cluster: this block's rank, the cluster's index and count along x.
__device__ __forceinline__ int cluster_rank() {
    unsigned r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return (int)r;
}
__device__ __forceinline__ int cluster_index() {
    unsigned r;
    asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
    return (int)r;
}
__device__ __forceinline__ int cluster_count() {
    unsigned r;
    asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
    return (int)r;
}
// The cluster barrier in two halves: arrive (release: this thread's
// accesses of shared memory before it are seen by every thread after the
// wait) and wait (acquire) for every thread of the cluster to arrive.
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// The shared::cluster address of p in block `rank`'s shared memory, and a
// store there.
__device__ __forceinline__ unsigned peer_address(const float* p, int rank) {
    unsigned out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(out)
                 : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(rank));
    return out;
}
__device__ __forceinline__ void store_peer(unsigned address, float v) {
    asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(address), "f"(v)
                 : "memory");
}

// The window a thread holds before the first group and after the last.
template <int B>
__host__ __device__ constexpr int first_window(bool forward) {
    return forward ? Plan<B>::w(0) : Plan<B>::w(Plan<B>::NG - 1);
}

}  // namespace
