// The major FFT pass of the scans, for Hopper (sm_90a), on the core of
// fft_passes.cuh.
//
// Replaces the Pallas TPU kernels of audio_matcher_tpu/ops/pallas_fft.py:
//   major_pass<In, false, false, false, B, W> <- fft_major_fwd_wire
//   major_pass<In, false, true, false, B, W>  <- fft_major_fwd_wire2
//   major_pass<float, false, true, true, B, W>
//                               <- fft_major(inverse=False, cross=True)
//   major_pass<float, true, false, true, B, W>
//                               <- fft_major(inverse=True, cross=True, a_crop)
// one instantiation per A = 2^B, 2^7 .. 2^12, and per cross twiddle W
// (root<W>): the one-call form up to fft_len 2^24, the split exponent above
// (A >= 2048); at A = 8192 and 16384 cluster_pass<In, INVERSE, PAIR,
// PLANES, B> in the same four modes (the split exponent).
//
// What is computed. The radix-2 DIF over the strided A axis of every column
// c of [P, A, M] (natural input, bit-reversed output), then physical row r
// times the cross twiddle W_n^{brev_A(r)*c}. The inverse applies the
// conjugate cross twiddle before undoing the stages (bit-reversed rows in,
// natural rows out, unscaled) and writes only the first a_crop rows. The
// wire modes decode mu-law or int16 in-register, with exp()-1 and no FMA
// contraction, and read zero at indices >= w_len; the pair mode packs two
// windows as fft(w0 + i*w1) and reads wire silence for the rows past the
// odd windows' count.
//
// What bounds it on an H100. Device-memory bytes: at the batch scan's slab
// the inverse reads 2 x 4.3 GB of product planes and writes 2 x 2.8 GB. A
// column's 16 points a thread are 16 rows apart, so a block works on a
// strip of C = 2^LOG2C columns (2^14 points: C = 32 columns, 128 bytes of a
// row, up to A = 512; 16 at 1024; 8 at 2048; 4 at 4096), 1024 threads of
// 64 registers, one block per SM; the strip's tile holds the exchanges. At
// A = 8192 and 16384 (fft_len 2^26 - 2^28) a block's 2^14 points would be
// strips of 2 and 1 columns, reading and writing 8 or 4 bytes of each
// 32-byte sector; there a cluster of A / 2048 blocks shares a strip of 8
// columns (the passes on clusters, below).
//
// What the design does about it.
//  * Stage groups in registers, two exchanges at A = 2048 (fft_passes.cuh).
//  * The f32 planes' modes (fft_major, fft_major_forward) run a persistent
//    block per SM that walks the strips. The next strip comes into shared
//    memory by cp.async, 16 bytes a copy with a 128-byte L2 prefetch (the
//    neighbouring strips, walked by the neighbouring blocks at the same
//    time, find their sectors there), while the block runs the current
//    strip's stages and stores: loads and stages overlap on every SM. The
//    copy lands in the exchange tile's layout, so the points come out of
//    it free of bank conflicts, and the exchanges go one plane at a time
//    through the one tile left beside it (3 tiles: 209 KB at A = 2048).
//  * The wire modes read 1 or 2 bytes a point and write 8: the stores are
//    their bound. They walk the strips the same way (walk_wire_strips): the
//    next strip's wire bytes come into shared memory by cp.async while the
//    block runs the current strip, and are decoded in registers on their
//    way to the stages; f32 windows never exist. Wire rows are strided
//    views with any start alignment (a window starts at b * chunk samples):
//    rows are copied in 16- or 8-byte chunks where their start allows it
//    (one copy a row at config #3's slab), else f32 rows in 4-byte chunks
//    and u8 and int16 rows in the 4-byte words their bytes touch
//    (wire_copy). The mu-law table is built once a block, 16 copies so
//    that its lookups meet at most two lanes a bank; the planes exchange
//    one after the other through one tile (WireLayout). A warp stores C * 4
//    contiguous bytes of each row: whole 32-byte sectors up to A = 2048.
//    At A = 4096 a row piece is half a sector, and there the TMA stores
//    the output from shared memory (stage_and_store), while the block goes
//    on with the next strip.
//  * The cross twiddle keeps its exact integer exponent brev_A(r)*c: one
//    sincospif per thread and 16 per column of a strip (build_cross,
//    apply_cross), one complex product per point; above fft_len 2^24 two
//    sincospif of the exponent's exact halves and a product (root).
//  * Offsets into the planes are 64-bit: one plane of the product output
//    holds 2^30 elements. The planes run along gridDim.x with the strips.
//
// Each C entry point returns cudaGetLastError() of its launch, or
// cudaErrorInvalidValue for a factor it has no instantiation for.

#include <cuda.h>  // CUtensorMap and its enums (headers only: no -lcuda)

#include "fft_passes.cuh"

namespace {

constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may use

// log2 of the rows of a strip one block transforms: all A up to 4096; 2048
// at A = 8192 and 16384, whose strips a cluster of A / 2048 blocks shares
// (ops/fft_plan.py's major_block_log2 and major_cluster_log2).
__host__ __device__ constexpr int block_log2(int log2A) {
    return log2A > 12 ? 11 : log2A;
}
__host__ __device__ constexpr int cluster_log2(int log2A) {
    return log2A - block_log2(log2A);
}
// log2 of the strip width: 2^14 points a block, 4 to 32 columns up to A =
// 4096 (ops/fft_plan.py's major_strip_log2; narrower strips would write 16
// bytes of each 32-byte sector at A = 2048); 8 columns, whole sectors, on
// the clusters of A = 8192 and 16384.
__host__ __device__ constexpr int strip_log2(int log2A) {
    return log2A > 12       ? 3
           : 14 - log2A > 5 ? 5
           : 14 - log2A < 2 ? 2
                            : 14 - log2A;
}
// threads a block: C * (the block's rows) / 16 (1024 from A = 512 up)
__host__ __device__ constexpr int threads_of(int log2A) {
    return 1 << (strip_log2(log2A) + block_log2(log2A) - LOG2_PTS);
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

// The cross twiddles W_n^{sign * e * D} of the strip's columns c0 + col,
// D = c * A/16, e < 16, at ct[col * 17 + e]: one sincospif of an exact
// integer exponent each (e * D < c * A < n).
template <int LOG2A, int LOG2C, bool WIDE>
__device__ __forceinline__ void build_cross(float2* ct, int c0, int log2n,
                                            float sign) {
    for (int k = threadIdx.x; k < (PTS << LOG2C); k += blockDim.x) {
        const int col = k >> LOG2_PTS, e = k & (PTS - 1);
        ct[col * (PTS + 1) + e] = root<WIDE>(
            e * ((c0 + col) << (LOG2A - LOG2_PTS)), log2n, sign);
    }
}

// Multiply the thread's 16 points, rows a = (u << 4) | r of column c, by
// the cross twiddle W_n^{sign * brev_A(a) * c}. brev_A(a) = brev_A(u << 4)
// + brev_4(r) * A/16, so with the exact integer exponent K0 =
// brev_A(u << 4) * c it is base * ct[col][brev_4(r)] with base = W^{K0}
// (cross_base): one sincospif per thread and one product per point, not a
// sincospif per point.
template <int LOG2A, bool WIDE>
__device__ __forceinline__ float2 cross_base(int u, int c, int log2n,
                                             float sign) {
    return root<WIDE>(brev_bits(u << LOG2_PTS, LOG2A) * c, log2n, sign);
}
__device__ __forceinline__ void apply_cross(float (&xr)[PTS],
                                            float (&xi)[PTS], float2 base,
                                            const float2* ct) {
#pragma unroll
    for (int r = 0; r < PTS; ++r) {
        const int e = ((r & 1) << 3) | ((r & 2) << 1) | ((r & 4) >> 1) |
                      ((r & 8) >> 3);  // brev_4(r)
        const float2 w = e ? cmul(base, ct[e]) : base;
        const float vr = xr[r], vi = xi[r];
        xr[r] = vr * w.x - vi * w.y;
        xi[r] = vr * w.y + vi * w.x;
    }
}

// The forward's stores: rows (u << 4) | r of column c of plane p.
__device__ __forceinline__ void store_forward(const float (&vr)[PTS],
                                              const float (&vi)[PTS],
                                              float* __restrict__ yr,
                                              float* __restrict__ yi,
                                              long long out, int log2M) {
#pragma unroll
    for (int r = 0; r < PTS; ++r) {
        yr[out + (r << log2M)] = vr[r];
        yi[out + (r << log2M)] = vi[r];
    }
}

// Start the copy of strip s of the f32 planes (plane s / strips, columns
// c0 .. c0 + C) into raw: both planes, in the exchange tile's layout, so a
// thread reads its first group's points as from a tile. One commit group.
// Copies are 16 bytes, or the whole row piece where it is shorter (a strip
// of 1 or 2 columns, which no pass takes since the cluster passes).
template <int LOG2A, int LOG2C>
__device__ __forceinline__ void fetch_strip(float* raw,
                                            const float* __restrict__ xr,
                                            const float* __restrict__ xi,
                                            int s, int log2M) {
    constexpr int PLANE = ((1 << LOG2A) + (1 << LOG2A) / 16) << LOG2C;
    constexpr int LOG2G = LOG2C < 2 ? LOG2C : 2;  // floats a copy
    constexpr int LOG2Q = LOG2C - LOG2G;  // copies a row of the strip
    constexpr int PER_PLANE = 1 << (LOG2A + LOG2Q);
    const int log2strips = log2M - LOG2C;
    const long long at = ((long long)(s >> log2strips) << (LOG2A + log2M)) +
                         ((s & ((1 << log2strips) - 1)) << LOG2C);
#pragma unroll 1
    for (int k = threadIdx.x; k < 2 * PER_PLANE; k += blockDim.x) {
        const int im = k >= PER_PLANE;
        const int kk = k - (im ? PER_PLANE : 0);
        const int a = kk >> LOG2Q, q = (kk & ((1 << LOG2Q) - 1)) << LOG2G;
        cp_async(raw + (im ? PLANE : 0) + ((a + (a >> 4)) << LOG2C) + q,
                 (im ? xi : xr) + at + ((long long)a << log2M) + q,
                 4 << LOG2G);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The f32 planes' passes: a persistent block walks strips s = blockIdx.x,
// + gridDim.x, ... of the P * M / C strips. The copy of the next strip into
// raw is in flight while the block runs the current strip's stages and
// stores; the exchanges go one plane at a time through the tile xt.
template <bool INVERSE, int LOG2A, bool WIDE>
__device__ __forceinline__ void walk_strips(
    const float* __restrict__ xr, const float* __restrict__ xi,
    float* __restrict__ yr, float* __restrict__ yi,
    const float2* __restrict__ tw, int log2M, int a_crop, int strips,
    float* smem) {
    constexpr int LOG2C = strip_log2(LOG2A);
    constexpr int TOP = LOG2A - LOG2_PTS;  // the window of the strided end
    constexpr int PLANE = ((1 << LOG2A) + (1 << LOG2A) / 16) << LOG2C;
    const int log2n = LOG2A + log2M;
    const int log2strips = log2M - LOG2C;
    float* raw = smem;               // two planes
    float* xt = smem + 2 * PLANE;    // the exchange tile, one plane
    float2* ct = reinterpret_cast<float2*>(xt + PLANE);
    // each thread's cross_base, made while few registers are live
    float2* bases = ct + ((PTS + 1) << LOG2C);
    const float sign = INVERSE ? 1.0f : -1.0f;
    constexpr int W0 = first_window<LOG2A>(!INVERSE);
    float vr[PTS], vi[PTS];

    fetch_strip<LOG2A, LOG2C>(raw, xr, xi, blockIdx.x, log2M);
    for (int s = blockIdx.x; s < strips; s += gridDim.x) {
        // the thread's place, the strip's plane and column: computed anew
        // in each strip, where they are needed (opaque)
        const int col = opaque(threadIdx.x) & ((1 << LOG2C) - 1);
        const int u = opaque(threadIdx.x) >> LOG2C;
        const MajorTile<LOG2C> tile{col};
        auto plane_of = [&](int k) { return (long long)(k >> log2strips); };
        auto column = [&](int k) {
            return ((k & ((1 << log2strips) - 1)) << LOG2C) +
                   (opaque(threadIdx.x) & ((1 << LOG2C) - 1));
        };
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();  // the strip is in raw; the last one's reads are done
        build_cross<LOG2A, LOG2C, WIDE>(ct, column(s) - col, log2n, sign);
        bases[threadIdx.x] =
            cross_base<LOG2A, WIDE>(u, column(s), log2n, sign);
#pragma unroll
        for (int r = 0; r < PTS; ++r) {
            vr[r] = raw[tile.word(u, W0, r)];
            vi[r] = raw[PLANE + tile.word(u, W0, r)];
        }
        __syncthreads();  // raw is free, the cross twiddles are built
        if (s + gridDim.x < strips)
            fetch_strip<LOG2A, LOG2C>(raw, xr, xi, s + gridDim.x, log2M);
        if constexpr (INVERSE) {
            apply_cross(vr, vi, bases[threadIdx.x], ct + col * (PTS + 1));
            transform<false, false, LOG2A>(vr, vi, xt, xt, tile, u, tw);
            const long long out = plane_of(s) * ((long long)a_crop << log2M) +
                                  ((long long)u << log2M) + column(s);
            const int step = 1 << (TOP + log2M);  // A/16 rows
#pragma unroll
            for (int r = 0; r < PTS; ++r) {  // rows u + r * A/16
                if (u + (r << TOP) < a_crop) {
                    yr[out + r * step] = vr[r];
                    yi[out + r * step] = vi[r];
                }
            }
        } else {
            transform<true, false, LOG2A>(vr, vi, xt, xt, tile, u, tw);
            apply_cross(vr, vi, bases[threadIdx.x], ct + col * (PTS + 1));
            store_forward(vr, vi, yr, yi,
                          (plane_of(s) << log2n) +
                              ((long long)u << (log2M + 4)) + column(s),
                          log2M);
        }
    }
}

// The TMA stores' boxes: a strip's C columns by this many rows (at most
// 256, the TMA's limit), A / box_rows a plane (ops/fft_plan.py's wire_box).
__host__ __device__ constexpr int box_rows(int log2A) {
    return log2A < 8 ? 1 << log2A : 256;
}

// The wire passes' shared memory (ops/fft_plan.py's wire_layout): the
// exchange tile, one plane (the planes exchange one after the other; both
// at once, in a tile twice the size, measured slower: probe_wire_pass.py);
// TMA: a dense [A, C] plane beside it that stages the real output plane for
// the TMA stores (the imaginary one is staged in the tile); the strip's
// wire bytes (A rows of STRIDE bytes a plane, two planes for PAIR); for
// mu-law the 256 decoded codes 16 times (lane l reads code v at v * 16 + l
// mod 16: at most two lanes a bank); the cross twiddles and a float2 a
// thread. The TMA stores the output where a strip's row piece is half a
// 32-byte sector (A = 4096, C = 4: a box row must be a multiple of 16
// bytes) and the staging plane fits (not for int16 and f32 pairs);
// elsewhere the threads store it themselves, which is faster where the
// pieces are whole sectors. At A = 8192 and 16384 the cluster passes use
// this layout at A = 2048, with their inner twiddles beside it.
template <typename In, bool PAIR, int LOG2A>
struct WireLayout {
    static constexpr int LOG2C = strip_log2(LOG2A);
    static constexpr int A = 1 << LOG2A;
    static constexpr int TILE = (A + A / 16) << LOG2C;  // floats a plane
    static constexpr int PIECE = (int)sizeof(In) << LOG2C;  // bytes a row
    // u8 and int16 rows: up to 4 bytes more a row (the lead of a 4-byte
    // word copy), rounded up to the widest copy, 16 bytes or the piece;
    // pieces under 4 bytes (strips of 1 or 2 columns, which no pass takes)
    // the words that the piece and its largest lead, 4 - sizeof(In)
    // bytes, touch
    static constexpr int WIDE = PIECE < 16 ? PIECE : 16;
    static constexpr int STRIDE =
        sizeof(In) == 4 ? PIECE
        : PIECE < 4     ? (PIECE + 4 - (int)sizeof(In) + 3) / 4 * 4
                        : (PIECE + 4 + WIDE - 1) / WIDE * WIDE;
    static constexpr int RAW = (PAIR ? 2 : 1) * A * STRIDE;  // bytes
    static constexpr int LUT_COPIES = 16;
    static constexpr int LUT = sizeof(In) == 1 ? 256 * LUT_COPIES : 0;
    static constexpr int REST = RAW + 4 * LUT + 8 * ((PTS + 1) << LOG2C) +
                                8 * threads_of(LOG2A);
    static constexpr bool TMA =
        (4 << LOG2C) == 16 && 4 * (TILE + (A << LOG2C)) + REST <= MAX_SMEM;
    static constexpr int STAGE = TMA ? A << LOG2C : 0;  // floats
    static constexpr int SMEM = 4 * (TILE + STAGE) + REST;
    static constexpr int BOX = box_rows(LOG2A);
    static_assert(SMEM <= MAX_SMEM, "the wire pass's shared memory");
};

// How one row piece of a strip (PIECE bytes from byte address `start`)
// is copied: f32 rows exactly, in chunks of g = 16, 8 or 4 bytes (the
// largest that divides the start, and at most the piece). u8 and int16 rows the same way in 16 or
// 8 bytes where the start and the piece allow it (one copy a row at config
// #3's 8-byte pieces); else in 4-byte words from the word that holds the
// first byte, so `lead` = start mod 4 bytes of the previous element ride
// in front and the words are exactly those the piece's bytes touch
// (ops/fft_plan.py's wire_copy).
struct WireCopy {
    int grain, lead, chunks;
};
template <typename In, int PIECE>
__device__ __forceinline__ WireCopy wire_copy(const In* start) {
    const unsigned a = (unsigned)(uintptr_t)start & 15u;
    if (sizeof(In) == 4) {
        const int g0 = a == 0 ? 16 : (a & 7) == 0 ? 8 : 4;
        const int g = g0 < PIECE ? g0 : PIECE;
        return {g, 0, PIECE / g};
    }
    if (PIECE >= 16 && a == 0) return {16, 0, PIECE / 16};
    if (PIECE >= 8 && (a & 7) == 0) return {8, 0, PIECE / 8};
    const int lead = (int)(a & 3u);
    return {4, lead, (lead + PIECE + 3) >> 2};
}

// Start the copy of one plane's piece of strip columns c0 .. c0 + C into
// raw: row a (elements a*M + c0 ..) at raw + a * STRIDE. A chunk is copied
// only if its first element lies below w_len; the points past w_len are
// masked when they are read.
template <typename In, bool PAIR, int LOG2A>
__device__ __forceinline__ void fetch_wire_plane(unsigned char* raw,
                                                 const In* piece, int c0,
                                                 int log2M, long long w_len) {
    using L = WireLayout<In, PAIR, LOG2A>;
    const WireCopy cp = wire_copy<In, L::PIECE>(piece);
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(piece) - cp.lead;
#pragma unroll 1
    for (int k = threadIdx.x; k < (cp.chunks << LOG2A); k += blockDim.x) {
        const int a = k / cp.chunks, j = k - a * cp.chunks;
        const int b = j * cp.grain - cp.lead;  // first byte in the piece
        const long long first = ((long long)a << log2M) + c0 +
                                (b > 0 ? b : 0) / (int)sizeof(In);
        if (first < w_len)
            cp_async(raw + a * L::STRIDE + j * cp.grain,
                     src + ((long long)a << log2M) * sizeof(In) +
                         j * cp.grain,
                     cp.grain);
    }
}

// The copy of strip s: plane s / (M / C), columns c0 .. c0 + C, of x and,
// for PAIR rows below x1_rows, of x1; the rows past x1_rows get a plane of
// the wire code of silence (stored, not copied). One commit group.
template <typename In, bool PAIR, int LOG2A>
__device__ __forceinline__ void fetch_wire(
    unsigned char* raw, const In* __restrict__ x, long long in_stride,
    const In* __restrict__ x1, long long x1_stride, int x1_rows, int s,
    int log2M, long long w_len) {
    using L = WireLayout<In, PAIR, LOG2A>;
    const int log2strips = log2M - L::LOG2C;
    const long long p = s >> log2strips;
    const int c0 = (s & ((1 << log2strips) - 1)) << L::LOG2C;
    fetch_wire_plane<In, PAIR, LOG2A>(raw, x + p * in_stride + c0, c0, log2M,
                                      w_len);
    if (PAIR && p < x1_rows) {
        fetch_wire_plane<In, PAIR, LOG2A>(raw + L::A * L::STRIDE,
                                          x1 + p * x1_stride + c0, c0, log2M,
                                          w_len);
    } else if (PAIR) {
        // four codes a word: mu-law's silence is 128, the others' 0
        const unsigned word = sizeof(In) == 1 ? 0x80808080u : 0u;
        unsigned* sil = reinterpret_cast<unsigned*>(raw + L::A * L::STRIDE);
        for (int k = threadIdx.x; k < L::A * L::STRIDE / 4; k += blockDim.x)
            sil[k] = word;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// gridDim.x, read where it is used: a volatile read is not held in a
// register across the stages, as the compiler holds a plain one.
__device__ __forceinline__ int grid_blocks() {
    int g;
    asm volatile("mov.u32 %0, %%nctaid.x;" : "=r"(g));
    return g;
}

// The TMA stores' completion (bulk async-groups of the issuing thread):
// until the reads of shared memory of all but the newest N groups are
// done, or until all is written.
template <int N>
__device__ __forceinline__ void tma_reads_done() {
    asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void tma_writes_done() {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// x[r] <- x[r ^ k] for a k < 2^BITS known only at run time: conditional
// swaps, one level a bit, so that no register is indexed at run time.
template <int BITS>
__device__ __forceinline__ void xor_permute(float (&x)[PTS], int k) {
#pragma unroll
    for (int b = 0; b < BITS; ++b) {
        const bool flip = (k >> b) & 1;
#pragma unroll
        for (int r = 0; r < PTS; ++r) {
            if (r & (1 << b)) continue;
            const float lo = x[r], hi = x[r | (1 << b)];
            x[r] = flip ? hi : lo;
            x[r | (1 << b)] = flip ? lo : hi;
        }
    }
}

// The forward wire pass's output of one strip, rows (u << 4) | r of column
// col, through shared memory to the TMA: the real plane is written into
// the staging plane sr, the imaginary one into the exchange tile si, each
// as a dense [A, C] array (the layout of a box of the tensor map); then
// threads t < A/BOX each store box t of BOX rows of both planes, columns
// c0 .. c0 + C of plane p, the imaginary plane's first: each box is a bulk
// async-group of the thread, so that the next strip waits only for the
// imaginary plane to leave the tile (tma_reads_done<1>) before its first
// exchange, and the real plane has until this point in the next strip. A
// warp holds 32/C values of u at each r: thread u writes register r ^ (u
// mod 32/C) at step r, so that the warp's rows differ modulo 32/C and its
// words fall in 32 banks.
template <int LOG2A, int LOG2C>
__device__ __forceinline__ void stage_and_store(
    float (&vr)[PTS], float (&vi)[PTS], float* sr, float* si, int col, int u,
    const CUtensorMap* out_r, const CUtensorMap* out_i, int c0, int p) {
    constexpr int A = 1 << LOG2A;
    constexpr int KBITS = 5 - LOG2C;  // log2 of the u values a warp holds
    constexpr int BOX = box_rows(LOG2A);
    const int k = u & ((1 << KBITS) - 1);
    const int t = threadIdx.x;
    xor_permute<KBITS>(vr, k);
    xor_permute<KBITS>(vi, k);
    if (t < A / BOX) tma_reads_done<0>();  // the last real plane left sr
    __syncthreads();  // and the last exchange's reads of the tile are done
#pragma unroll
    for (int r = 0; r < PTS; ++r) {
        const int w = ((((u << LOG2_PTS) | r) ^ k) << LOG2C) | col;
        sr[w] = vr[r];
        si[w] = vi[r];
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the strip's output is in sr and si
    if (t < A / BOX) {
#pragma unroll
        for (int im = 1; im >= 0; --im) {
            const unsigned src = (unsigned)__cvta_generic_to_shared(
                (im ? si : sr) + ((t * BOX) << LOG2C));
            asm volatile(
                "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
                " [%0, {%2, %3, %4}], [%1];\n"
                :: "l"(im ? out_i : out_r), "r"(src), "r"(c0),
                   "r"(t * BOX), "r"(p)
                : "memory");
            asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
    }
}

// The wire passes, forward only: a persistent block walks strips s =
// blockIdx.x, + gridDim.x, ... of the P * M / C strips, as walk_strips
// does. The next strip's wire bytes come into raw by cp.async while the
// block runs the current strip's stages, and (TMA) the TMA stores the last
// strip's output from shared memory while the block works on the next
// (stage_and_store). x is the real wire-dtype input, row p at x +
// p*in_stride, element (a, c) at a*M + c, read only below w_len (zero past
// it); output [P, A, M] planes (out_r, out_i: their tensor maps). PAIR:
// the imaginary plane is read the same way from x1 + p*x1_stride for p <
// x1_rows; rows p >= x1_rows pair with wire silence (the pad window of an
// odd slab), decoded like any sample. Decoding is in-register (the mu-law
// table is built once a block).
template <typename In, bool PAIR, int LOG2A, bool WIDE>
__device__ __forceinline__ void walk_wire_strips(
    const In* __restrict__ x, long long in_stride, const In* __restrict__ x1,
    long long x1_stride, int x1_rows, float* __restrict__ yr,
    float* __restrict__ yi, const CUtensorMap* out_r,
    const CUtensorMap* out_i, const float2* __restrict__ tw, int log2M,
    long long w_len, int strips, float* smem) {
    using L = WireLayout<In, PAIR, LOG2A>;
    using Pl = Plan<LOG2A>;
    constexpr int LOG2C = L::LOG2C;
    constexpr int TOP = LOG2A - LOG2_PTS;
    float* xt = smem;  // the exchange tile
    float* stage = smem + L::TILE;  // TMA: the real output plane
    unsigned char* raw =
        reinterpret_cast<unsigned char*>(stage + L::STAGE);
    float* lut = reinterpret_cast<float*>(raw + L::RAW);
    float2* ct = reinterpret_cast<float2*>(lut + L::LUT);
    float2* bases = ct + ((PTS + 1) << LOG2C);
    float vr[PTS], vi[PTS];

    if (sizeof(In) == 1)
        for (int k = threadIdx.x; k < L::LUT; k += blockDim.x)
            lut[k] = dequant((uint8_t)(k / L::LUT_COPIES));
    fetch_wire<In, PAIR, LOG2A>(raw, x, in_stride, x1, x1_stride, x1_rows,
                                blockIdx.x, log2M, w_len);
    for (int s = blockIdx.x; s < strips; s += grid_blocks()) {
        // the thread's place, the strip's plane and column, and what
        // derives from log2M: computed anew in each strip, where they are
        // needed (opaque), not held across the stages
        const int lm = opaque(log2M);
        const int log2n = LOG2A + lm, log2strips = lm - LOG2C;
        const int col = opaque(threadIdx.x) & ((1 << LOG2C) - 1);
        const int u = opaque(threadIdx.x) >> LOG2C;
        const long long p = s >> log2strips;
        const int c0 = (s & ((1 << log2strips) - 1)) << LOG2C;
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();  // the strip is in raw; the last one's reads are done
        build_cross<LOG2A, LOG2C, WIDE>(ct, c0, log2n, -1.0f);
        bases[threadIdx.x] =
            cross_base<LOG2A, WIDE>(u, c0 + col, log2n, -1.0f);
        {
            const float* lane_lut = lut + (threadIdx.x & (L::LUT_COPIES - 1));
            auto decode = [lane_lut](In v) {
                return sizeof(In) == 1
                           ? lane_lut[(uint8_t)v * L::LUT_COPIES]
                           : dequant(v);
            };
            // rows a = u + r * A/16 of column c, read below w_len: a < a_end
            const int c = c0 + col;
            const long long ends = (w_len - c + (1LL << lm) - 1) >> lm;
            const int a_end = (int)(ends < 0 ? 0 : ends < L::A ? ends : L::A);
            const int at = u * L::STRIDE + col * (int)sizeof(In);
            const unsigned char* r0 =
                raw + at +
                wire_copy<In, L::PIECE>(x + p * in_stride + c0).lead;
            const unsigned char* r1 =
                raw + L::A * L::STRIDE + at +
                (PAIR && p < x1_rows
                     ? wire_copy<In, L::PIECE>(x1 + p * x1_stride + c0).lead
                     : 0);
            constexpr int STEP = (L::A / PTS) * L::STRIDE;  // A/16 rows
#pragma unroll
            for (int r = 0; r < PTS; ++r) {
                const bool in = u + (r << TOP) < a_end;
                vr[r] = in ? decode(*reinterpret_cast<const In*>(
                                 r0 + r * STEP))
                           : 0.0f;
                vi[r] = PAIR && in ? decode(*reinterpret_cast<const In*>(
                                         r1 + r * STEP))
                                   : 0.0f;
            }
        }
        __syncthreads();  // raw is free, the cross twiddles are built
        const int next = opaque(s) + grid_blocks();  // not kept: opaque
        if (next < strips)
            fetch_wire<In, PAIR, LOG2A>(raw, x, in_stride, x1, x1_stride,
                                        x1_rows, next, lm, w_len);
        const MajorTile<LOG2C> tile{opaque(threadIdx.x) & ((1 << LOG2C) - 1)};
        const int u2 = opaque(threadIdx.x) >> LOG2C;
        if constexpr (L::TMA) {
            // the first group needs no tile: the TMA may read the last
            // strip's imaginary plane from it until then
            run_group<true, Pl::w(0), Pl::qlo(0), Pl::k(0)>(vr, vi, u2, tw);
            if (opaque(threadIdx.x) < L::A / L::BOX) tma_reads_done<1>();
            transform<true, false, LOG2A, 1>(vr, vi, xt, xt, tile, u2, tw);
        } else {
            transform<true, false, LOG2A>(vr, vi, xt, xt, tile, u2, tw);
        }
        // physical row a holds frequency brev(a): twiddle W_n^{brev(a)*c};
        // the strip's place again (opaque), not held across the stages
        const int tid = opaque(threadIdx.x);
        const unsigned s2 = (unsigned)opaque(s);
        const int lm2 = opaque(log2M), strips2 = lm2 - LOG2C;
        const int col2 = tid & ((1 << LOG2C) - 1);
        apply_cross(vr, vi, bases[tid], ct + col2 * (PTS + 1));
        if constexpr (L::TMA)
            stage_and_store<LOG2A, LOG2C>(
                vr, vi, stage, xt, col2, tid >> LOG2C, out_r, out_i,
                (int)((s2 & ((1u << strips2) - 1)) << LOG2C),
                (int)(s2 >> strips2));
        else
            store_forward(vr, vi, yr, yi,
                          ((long long)(s2 >> strips2) << (LOG2A + lm2)) +
                              ((long long)(tid >> LOG2C) << (lm2 + 4)) +
                              ((s2 & ((1u << strips2) - 1)) << LOG2C) + col2,
                          lm2);
    }
    if constexpr (L::TMA) tma_writes_done();  // before the block's exit
}

// ------------------------------------------------ the passes on clusters
// The major pass at A = 8192 and 16384 (fft_len 2^26 - 2^28). A strip of C
// = 8 columns, whole 32-byte sectors of every row, would need 278 and 557
// KB of tile, so a cluster of K = A / 2048 blocks (4, 8: a portable size)
// shares it. With a = b + K*a1 and k = k1 + 2048*k2,
//   X[k] = sum_b W_K^{b*k2} W_A^{b*k1} sum_a1 x[b + K*a1] W_2048^{a1*k1}:
// block b (its rank in the cluster) holds rows a = b + K*a1 and runs the
// 2048-point DIF over a1 as a block of A = 2048 does (1024 threads, the
// same plan, twiddles and tile), then the inner twiddle W_A^{b*k1}.
// Position r1 of that DIF holds k1 = brev_2048(r1); one all-to-all through
// distributed shared memory sends it to block r1 / R (R = 2048 / K), whose
// thread (col, v) holds rows r1 = b'*R + v + 128*j of every block in
// registers j*K + b and runs the K-point DIF over b there. Register j*K +
// r2 then holds k2 = brev_K(r2), the frequency of physical row K*r1 + r2:
// with the cross twiddle W_n^{brev_A(r)*c}, Y[r] = X[brev_A(r)], the
// layout of every other A. The inverse runs the steps backwards: block b'
// reads physical rows 2048*b' + rho, applies the conjugate cross twiddle,
// runs the K-point inverse in registers and sends residue b to block b; the
// conjugate inner twiddle and the 2048-point inverse give natural rows a =
// b + K*a1, written where a < a_crop. Reads and writes stay one pass over
// the planes in whole sectors; the exchange sends each point once through
// the cluster, one plane at a time through the one tile (the next strip,
// in flight by cp.async, fills the rest of the block's 227 KB), and four
// cluster barriers a strip order it (ops/fft_plan.py mirrors every index
// map, and a CPU test runs the decomposition with them).

template <int LOG2A>
struct Cluster {
    static constexpr int LOG2K = cluster_log2(LOG2A);  // blocks: 4 or 8
    static constexpr int K = 1 << LOG2K;
    static constexpr int LOG2B = block_log2(LOG2A);  // a block's rows, 2048
    static constexpr int LOG2C = strip_log2(LOG2A);  // 8 columns
    static constexpr int LOG2R = LOG2B - LOG2K;  // positions a block owns
    static constexpr int THREADS = threads_of(LOG2A);
    static constexpr int TILE = ((1 << LOG2B) + (1 << LOG2B) / 16) << LOG2C;
    static constexpr int INNER = 128 + PTS;  // inner twiddles (float2)
    static constexpr int CT = (PTS + 1) << LOG2C;  // cross twiddles (float2)
    static_assert(THREADS == 1024 && LOG2C == 3 && LOG2B == 11 && LOG2K >= 2,
                  "the cluster passes' thread map");
};

// The inner twiddles of block b, once a kernel: it[u] = W_A^{sign * b *
// brev_2048(u << 4)} (u < 128) and it[128 + e] = W_A^{sign * b * 128 * e},
// so that apply_cross(.., it[u], it + 128) multiplies position (u << 4) | r
// by W_A^{sign * b * brev_2048((u << 4) | r)}. Exponents below A: exact.
template <int LOG2A>
__device__ __forceinline__ void build_inner(float2* it, float sign) {
    const int b = cluster_rank();
    for (int k = threadIdx.x; k < Cluster<LOG2A>::INNER; k += blockDim.x)
        it[k] = root<false>(
            b * (k < 128 ? brev_bits(k << LOG2_PTS, 11) : (k - 128) << 7),
            LOG2A, sign);
}

// The cross twiddles of physical rows K*r1 + r2, r1 = b'*R + v + 128*j, of
// strip columns c0 + col: brev_A of the row is brev_2048(b'*R + v) (the
// thread's, cluster_cross_base) plus E(r) = brev_2048(128*j) + 2048 *
// brev_K(r2) of register r = j*K + r2, at ct[col * 17 + r] (exponents E(r)
// * c < n, exact in root<true>).
template <int LOG2K>
__device__ __forceinline__ int cluster_cross_exponent(int r) {
    return brev_bits((r >> LOG2K) << 7, 11) +
           (brev_bits(r & ((1 << LOG2K) - 1), LOG2K) << 11);
}
template <int LOG2A>
__device__ __forceinline__ void build_cluster_cross(float2* ct, int c0,
                                                    int log2n, float sign) {
    using Cl = Cluster<LOG2A>;
    for (int k = threadIdx.x; k < (PTS << Cl::LOG2C); k += blockDim.x) {
        const int col = k >> LOG2_PTS, r = k & (PTS - 1);
        ct[col * (PTS + 1) + r] = root<true>(
            cluster_cross_exponent<Cl::LOG2K>(r) * (c0 + col), log2n, sign);
    }
}
template <int LOG2A>
__device__ __forceinline__ float2 cluster_cross_base(int v, int c,
                                                     int log2n, float sign) {
    using Cl = Cluster<LOG2A>;
    return root<true>(brev_bits((cluster_rank() << Cl::LOG2R) + v, 11) * c,
                      log2n, sign);
}
// Register r times base * t[r] (t[0] = 1).
__device__ __forceinline__ void apply_table(float (&xr)[PTS],
                                            float (&xi)[PTS], float2 base,
                                            const float2* t) {
#pragma unroll
    for (int r = 0; r < PTS; ++r) {
        const float2 w = r ? cmul(base, t[r]) : base;
        const float vr = xr[r], vi = xi[r];
        xr[r] = vr * w.x - vi * w.y;
        xi[r] = vr * w.y + vi * w.x;
    }
}

// The exchange tile's word of slot s (the A = 2048 tile: rows of 8 words,
// a padding row per 16) in column col.
__device__ __forceinline__ int cluster_word(int s, int col) {
    return ((s + (s >> 4)) << 3) + col;
}

// Forward: thread (col, u) of block b sends positions r1 = (u << 4) | r of
// one plane to block r1 / R, slots b*R + r1 mod R (16 consecutive slots: a
// base address and immediates); thread (col, v) of that block takes slot
// b*R + 128*j + v into register j*K + b.
template <int LOG2A>
__device__ __forceinline__ void push_forward(const float (&x)[PTS],
                                             float* xt) {
    using Cl = Cluster<LOG2A>;
    constexpr int LOW = 7 - Cl::LOG2K;  // bits of u below the destination
    const int tid = threadIdx.x, u = tid >> 3;
    const int s0 = (cluster_rank() << Cl::LOG2R) +
                   ((u & ((1 << LOW) - 1)) << LOG2_PTS);
    const unsigned at = peer_address(xt + cluster_word(s0, tid & 7), u >> LOW);
#pragma unroll
    for (int r = 0; r < PTS; ++r) store_peer(at + 32 * r, x[r]);
}
template <int LOG2A>
__device__ __forceinline__ void pull_forward(float (&x)[PTS],
                                             const float* xt) {
    using Cl = Cluster<LOG2A>;
    const int tid = threadIdx.x, v = tid >> 3;
    const float* p = xt + cluster_word(v, tid & 7);
#pragma unroll
    for (int r = 0; r < PTS; ++r) {
        const int j = r >> Cl::LOG2K, b = r & (Cl::K - 1);
        x[r] = p[(((b << Cl::LOG2R) + (j << 7)) * 17 / 16) << 3];
    }
}
// Inverse: thread (col, v) of block b' sends register j*K + b (residue b of
// row r1 = b'*R + v + 128*j) to block b, slot r1; thread (col, u) of that
// block takes positions (u << 4) | r, the first window of its 2048-point
// inverse.
template <int LOG2A>
__device__ __forceinline__ void push_inverse(const float (&x)[PTS],
                                             float* xt) {
    using Cl = Cluster<LOG2A>;
    const int tid = threadIdx.x, v = tid >> 3;
    const float* p = xt + cluster_word((cluster_rank() << Cl::LOG2R) + v,
                                       tid & 7);
#pragma unroll
    for (int b = 0; b < Cl::K; ++b) {
        const unsigned at = peer_address(p, b);
#pragma unroll
        for (int j = 0; j < (PTS >> Cl::LOG2K); ++j)
            store_peer(at + 4 * ((136 * j) << 3), x[(j << Cl::LOG2K) + b]);
    }
}

// The all-to-all of both planes, one after the other through xt: wait for
// every block to be done with its tile (the arrive before is the caller's),
// send the real plane, barrier, take it, barrier, the imaginary plane the
// same way.
template <bool INVERSE, int LOG2A>
__device__ __forceinline__ void cluster_exchange(float (&vr)[PTS],
                                                 float (&vi)[PTS], float* xt,
                                                 MajorTile<3> tile, int u) {
    cluster_wait();
    if (INVERSE) push_inverse<LOG2A>(vr, xt);
    else push_forward<LOG2A>(vr, xt);
    cluster_arrive();
    cluster_wait();  // the real plane is in every block
    if (INVERSE) {
#pragma unroll
        for (int r = 0; r < PTS; ++r) vr[r] = xt[tile.word(u, 0, r)];
    } else {
        pull_forward<LOG2A>(vr, xt);
    }
    cluster_arrive();
    cluster_wait();  // and read
    if (INVERSE) push_inverse<LOG2A>(vi, xt);
    else push_forward<LOG2A>(vi, xt);
    cluster_arrive();
    cluster_wait();
    if (INVERSE) {
#pragma unroll
        for (int r = 0; r < PTS; ++r) vi[r] = xt[tile.word(u, 0, r)];
    } else {
        pull_forward<LOG2A>(vi, xt);
    }
}

// The block's 2048-point transform; the arrive that lets the cluster's
// blocks write into xt again comes after the last exchange, before the last
// group's stages.
template <bool FORWARD>
__device__ __forceinline__ void block_transform(float (&vr)[PTS],
                                                float (&vi)[PTS], float* xt,
                                                MajorTile<3> tile, int u,
                                                const float2* tw) {
    using Pl = Plan<11>;
    constexpr int LAST = FORWARD ? Pl::NG - 1 : 0;
    constexpr int BEFORE = FORWARD ? LAST - 1 : 1;
    transform<FORWARD, false, 11, 0, Pl::NG - 1>(vr, vi, xt, xt, tile, u, tw);
    exchange<false, Pl::w(BEFORE), Pl::w(LAST)>(vr, vi, xt, xt, tile, u);
    cluster_arrive();
    run_group<FORWARD, Pl::w(LAST), Pl::qlo(LAST), Pl::k(LAST)>(vr, vi, u,
                                                                 tw);
}

// The forward's end of a strip, from the block's 2048-point DIF (positions
// (u << 4) | r): the inner twiddle, the exchange, the K-point DIF, the cross
// twiddle and the stores of physical rows K*r1 + r2 of plane p, columns c0
// + col: whole 32-byte sectors.
template <int LOG2A>
__device__ __forceinline__ void forward_tail(
    float (&vr)[PTS], float (&vi)[PTS], float* xt, const float2* it,
    const float2* ct, const float2* bases, const float2* __restrict__ tw,
    float* __restrict__ yr, float* __restrict__ yi, int s, int log2M) {
    using Cl = Cluster<LOG2A>;
    {
        const int u = opaque(threadIdx.x) >> 3;
        apply_cross(vr, vi, it[u], it + 128);
        cluster_exchange<false, LOG2A>(
            vr, vi, xt, MajorTile<3>{opaque(threadIdx.x) & 7}, u);
    }
    run_group<true, 0, 0, Cl::LOG2K>(vr, vi, 0, tw);
    const int tid = opaque(threadIdx.x), col = tid & 7, v = tid >> 3;
    apply_table(vr, vi, bases[tid], ct + col * (PTS + 1));
    const int lm = opaque(log2M), log2strips = lm - 3;
    const unsigned s2 = (unsigned)opaque(s);
    const long long out =
        ((long long)(s2 >> log2strips) << (LOG2A + lm)) +
        ((long long)((cluster_rank() << 11) + (v << Cl::LOG2K)) << lm) +
        ((s2 & ((1u << log2strips) - 1)) << 3) + col;
#pragma unroll
    for (int r = 0; r < PTS; ++r) {
        const long long row = ((r >> Cl::LOG2K) << (7 + Cl::LOG2K)) +
                              (r & (Cl::K - 1));
        yr[out + (row << lm)] = vr[r];
        yi[out + (row << lm)] = vi[r];
    }
}

// Start the copy of block b's rows of strip s of the f32 planes into raw,
// 16 bytes a copy, two a row piece. Forward: rows b + K*a1 at row a1 of the
// A = 2048 tile. Inverse: rows 2048*b + rho at row slot rho ^ ((rho >>
// log2K) & 3), unpadded, so that the threads' reads of rows K*(v + 128*j)
// + r2 (v mod 4 differs in a warp) meet no bank twice. One commit group.
template <bool INVERSE, int LOG2A>
__device__ __forceinline__ void fetch_cluster_strip(
    float* raw, const float* __restrict__ xr, const float* __restrict__ xi,
    int s, int log2M) {
    using Cl = Cluster<LOG2A>;
    const int b = cluster_rank();
    const int log2strips = log2M - 3;
    const long long at = ((long long)(s >> log2strips) << (LOG2A + log2M)) +
                         ((s & ((1 << log2strips) - 1)) << 3);
#pragma unroll 1
    for (int k = threadIdx.x; k < 2 << 12; k += blockDim.x) {
        const int im = k >> 12, a = (k >> 1) & 2047, q = (k & 1) << 2;
        const int slot = INVERSE ? (a ^ ((a >> Cl::LOG2K) & 3)) << 3
                                 : (a + (a >> 4)) << 3;
        const long long row =
            INVERSE ? (long long)((b << 11) + a)
                    : b + ((long long)a << Cl::LOG2K);
        cp_async(raw + (im ? Cl::TILE : 0) + slot + q,
                 (im ? xi : xr) + at + (row << log2M) + q, 16);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The f32 planes' passes on a cluster: cluster i walks strips i, i +
// clusters, ...; the next strip's copy is in flight while the block works
// on the current one, as in walk_strips. Shared memory: raw (two planes),
// the exchange tile xt, the cross twiddles, a cross base a thread, the
// inner twiddles.
template <bool INVERSE, int LOG2A>
__device__ __forceinline__ void walk_cluster_strips(
    const float* __restrict__ xr, const float* __restrict__ xi,
    float* __restrict__ yr, float* __restrict__ yi,
    const float2* __restrict__ tw, int log2M, int a_crop, int strips,
    float* smem) {
    using Cl = Cluster<LOG2A>;
    float* raw = smem;
    float* xt = smem + 2 * Cl::TILE;
    float2* ct = reinterpret_cast<float2*>(xt + Cl::TILE);
    float2* bases = ct + Cl::CT;
    float2* it = bases + Cl::THREADS;
    const float sign = INVERSE ? 1.0f : -1.0f;
    constexpr int W0 = first_window<11>(true);
    float vr[PTS], vi[PTS];

    build_inner<LOG2A>(it, sign);
    fetch_cluster_strip<INVERSE, LOG2A>(raw, xr, xi, cluster_index(), log2M);
    if (INVERSE) cluster_arrive();  // the tile is free
    for (int s = cluster_index(); s < strips; s += cluster_count()) {
        const int lm = opaque(log2M);
        const int col = opaque(threadIdx.x) & 7;
        const int u = opaque(threadIdx.x) >> 3;
        const int c0 = (s & ((1 << (lm - 3)) - 1)) << 3;
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();  // the strip is in raw; the last one's reads are done
        build_cluster_cross<LOG2A>(ct, c0, LOG2A + lm, sign);
        bases[threadIdx.x] =
            cluster_cross_base<LOG2A>(u, c0 + col, LOG2A + lm, sign);
        if (INVERSE) {
            // rows K*(u + 128*j) + r2 into register j*K + r2
            const int k = u & 3;
            const float* p = raw + (u << (Cl::LOG2K + 3)) + col;
#pragma unroll
            for (int r = 0; r < PTS; ++r) {
                const int w = (((r >> Cl::LOG2K) << (7 + Cl::LOG2K)) +
                               ((r & (Cl::K - 1)) ^ k)) << 3;
                vr[r] = p[w];
                vi[r] = p[Cl::TILE + w];
            }
        } else {
            const MajorTile<3> tile{col};
#pragma unroll
            for (int r = 0; r < PTS; ++r) {
                vr[r] = raw[tile.word(u, W0, r)];
                vi[r] = raw[Cl::TILE + tile.word(u, W0, r)];
            }
        }
        __syncthreads();  // raw is free, the cross twiddles are built
        if (s + cluster_count() < strips)
            fetch_cluster_strip<INVERSE, LOG2A>(raw, xr, xi,
                                                s + cluster_count(), lm);
        if constexpr (INVERSE) {
            const int tid = opaque(threadIdx.x);
            apply_table(vr, vi, bases[tid], ct + (tid & 7) * (PTS + 1));
            run_group<false, 0, 0, Cl::LOG2K>(vr, vi, 0, tw);
            const int u2 = opaque(threadIdx.x) >> 3;
            const MajorTile<3> tile{opaque(threadIdx.x) & 7};
            cluster_exchange<true, LOG2A>(vr, vi, xt, tile, u2);
            apply_cross(vr, vi, it[u2], it + 128);
            block_transform<false>(vr, vi, xt, tile, u2, tw);
            // natural rows a = b + K*(u + 128*r), the first a_crop
            const int lm2 = opaque(log2M), log2strips = lm2 - 3;
            const unsigned s2 = (unsigned)opaque(s);
            const int t2 = opaque(threadIdx.x);
            const int a0 = cluster_rank() + ((t2 >> 3) << Cl::LOG2K);
            const long long out =
                (long long)(s2 >> log2strips) * ((long long)a_crop << lm2) +
                ((long long)a0 << lm2) +
                ((s2 & ((1u << log2strips) - 1)) << 3) + (t2 & 7);
#pragma unroll
            for (int r = 0; r < PTS; ++r) {
                if (a0 + (r << (7 + Cl::LOG2K)) < a_crop) {
                    const long long o =
                        out + ((long long)(r << (7 + Cl::LOG2K)) << lm2);
                    yr[o] = vr[r];
                    yi[o] = vi[r];
                }
            }
        } else {
            block_transform<true>(vr, vi, xt, MajorTile<3>{col}, u, tw);
            forward_tail<LOG2A>(vr, vi, xt, it, ct, bases, tw, yr, yi, s,
                                log2M);
        }
    }
    if (INVERSE) cluster_wait();  // the last arrive's
}

// The wire passes on a cluster: one plane's rows b + K*a1 (a1 < 2048) of
// strip columns c0 .. c0 + 8 into raw, row a1 at raw + a1 * STRIDE, as
// fetch_wire_plane copies A = 2048's rows (all rows of a piece share its
// start's alignment: M * sizeof(In) is a multiple of 128 bytes).
template <typename In, bool PAIR, int LOG2A>
__device__ __forceinline__ void fetch_cluster_wire_plane(unsigned char* raw,
                                                         const In* piece,
                                                         int c0, int log2M,
                                                         long long w_len) {
    using L = WireLayout<In, PAIR, 11>;
    constexpr int LOG2K = Cluster<LOG2A>::LOG2K;
    const int b = cluster_rank();
    const WireCopy cp = wire_copy<In, L::PIECE>(piece);
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(piece) - cp.lead;
#pragma unroll 1
    for (int k = threadIdx.x; k < (cp.chunks << 11); k += blockDim.x) {
        const int a = k / cp.chunks, j = k - a * cp.chunks;
        const int first_byte = j * cp.grain - cp.lead;
        const long long row = b + ((long long)a << LOG2K);
        const long long first = (row << log2M) + c0 +
                                (first_byte > 0 ? first_byte : 0) /
                                    (int)sizeof(In);
        if (first < w_len)
            cp_async(raw + a * L::STRIDE + j * cp.grain,
                     src + (row << log2M) * sizeof(In) + j * cp.grain,
                     cp.grain);
    }
}
template <typename In, bool PAIR, int LOG2A>
__device__ __forceinline__ void fetch_cluster_wire(
    unsigned char* raw, const In* __restrict__ x, long long in_stride,
    const In* __restrict__ x1, long long x1_stride, int x1_rows, int s,
    int log2M, long long w_len) {
    using L = WireLayout<In, PAIR, 11>;
    const int log2strips = log2M - 3;
    const long long p = s >> log2strips;
    const int c0 = (s & ((1 << log2strips) - 1)) << 3;
    fetch_cluster_wire_plane<In, PAIR, LOG2A>(raw, x + p * in_stride + c0,
                                              c0, log2M, w_len);
    if (PAIR && p < x1_rows) {
        fetch_cluster_wire_plane<In, PAIR, LOG2A>(
            raw + L::A * L::STRIDE, x1 + p * x1_stride + c0, c0, log2M,
            w_len);
    } else if (PAIR) {
        const unsigned word = sizeof(In) == 1 ? 0x80808080u : 0u;
        unsigned* sil = reinterpret_cast<unsigned*>(raw + L::A * L::STRIDE);
        for (int k = threadIdx.x; k < L::A * L::STRIDE / 4; k += blockDim.x)
            sil[k] = word;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The wire passes, forward only, on a cluster: walk_wire_strips' decode at
// A = 2048's layout (WireLayout<In, PAIR, 11>: the exchange tile, the
// strip's wire rows, the mu-law table, the cross twiddles and a cross base
// a thread) and the inner twiddles, with the forward's cluster steps.
template <typename In, bool PAIR, int LOG2A>
__device__ __forceinline__ void walk_cluster_wire_strips(
    const In* __restrict__ x, long long in_stride, const In* __restrict__ x1,
    long long x1_stride, int x1_rows, float* __restrict__ yr,
    float* __restrict__ yi, const float2* __restrict__ tw, int log2M,
    long long w_len, int strips, float* smem) {
    using L = WireLayout<In, PAIR, 11>;
    using Cl = Cluster<LOG2A>;
    float* xt = smem;
    unsigned char* raw = reinterpret_cast<unsigned char*>(smem + L::TILE);
    float* lut = reinterpret_cast<float*>(raw + L::RAW);
    float2* ct = reinterpret_cast<float2*>(lut + L::LUT);
    float2* bases = ct + Cl::CT;
    float2* it = bases + Cl::THREADS;
    float vr[PTS], vi[PTS];

    if (sizeof(In) == 1)
        for (int k = threadIdx.x; k < L::LUT; k += blockDim.x)
            lut[k] = dequant((uint8_t)(k / L::LUT_COPIES));
    build_inner<LOG2A>(it, -1.0f);
    fetch_cluster_wire<In, PAIR, LOG2A>(raw, x, in_stride, x1, x1_stride,
                                        x1_rows, cluster_index(), log2M,
                                        w_len);
    for (int s = cluster_index(); s < strips; s += cluster_count()) {
        const int lm = opaque(log2M);
        const int log2n = LOG2A + lm, log2strips = lm - 3;
        const int col = opaque(threadIdx.x) & 7;
        const int u = opaque(threadIdx.x) >> 3;
        const long long p = s >> log2strips;
        const int c0 = (s & ((1 << log2strips) - 1)) << 3;
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();  // the strip is in raw; the last one's reads are done
        build_cluster_cross<LOG2A>(ct, c0, log2n, -1.0f);
        bases[threadIdx.x] = cluster_cross_base<LOG2A>(u, c0 + col, log2n,
                                                       -1.0f);
        {
            const float* lane_lut = lut + (threadIdx.x & (L::LUT_COPIES - 1));
            auto decode = [lane_lut](In v) {
                return sizeof(In) == 1
                           ? lane_lut[(uint8_t)v * L::LUT_COPIES]
                           : dequant(v);
            };
            // natural rows of column c below w_len: a < a_end; this
            // block's rows b + K*a1 among them: a1 < a1_end
            const int c = c0 + col;
            const long long ends = (w_len - c + (1LL << lm) - 1) >> lm;
            const int a_end = (int)(ends < 0 ? 0
                                    : ends < (1 << LOG2A) ? ends
                                                          : 1 << LOG2A);
            const int b = cluster_rank();
            const int a1_end =
                a_end > b ? (a_end - b + Cl::K - 1) >> Cl::LOG2K : 0;
            const int at = u * L::STRIDE + col * (int)sizeof(In);
            const unsigned char* r0 =
                raw + at +
                wire_copy<In, L::PIECE>(x + p * in_stride + c0).lead;
            const unsigned char* r1 =
                raw + L::A * L::STRIDE + at +
                (PAIR && p < x1_rows
                     ? wire_copy<In, L::PIECE>(x1 + p * x1_stride + c0).lead
                     : 0);
            constexpr int STEP = (L::A / PTS) * L::STRIDE;  // 128 rows
#pragma unroll
            for (int r = 0; r < PTS; ++r) {
                const bool in = u + (r << 7) < a1_end;
                vr[r] = in ? decode(*reinterpret_cast<const In*>(
                                 r0 + r * STEP))
                           : 0.0f;
                vi[r] = PAIR && in ? decode(*reinterpret_cast<const In*>(
                                         r1 + r * STEP))
                                   : 0.0f;
            }
        }
        __syncthreads();  // raw is free, the cross twiddles are built
        const int next = opaque(s) + cluster_count();  // not kept: opaque
        if (next < strips)
            fetch_cluster_wire<In, PAIR, LOG2A>(raw, x, in_stride, x1,
                                                x1_stride, x1_rows, next, lm,
                                                w_len);
        block_transform<true>(vr, vi, xt,
                              MajorTile<3>{opaque(threadIdx.x) & 7},
                              opaque(threadIdx.x) >> 3, tw);
        forward_tail<LOG2A>(vr, vi, xt, it, ct, bases, tw, yr, yi, s,
                            log2M);
    }
}

// One block of a cluster (Cluster<LOG2A>: 1024 threads, all of the SM's
// registers): the f32 planes (walk_cluster_strips; the inverse writes [P,
// a_crop, M]) or the wire (walk_cluster_wire_strips).
template <typename In, bool INVERSE, bool PAIR, bool PLANES, int LOG2A>
__global__ void __launch_bounds__(1024, 1)
cluster_pass(const In* __restrict__ x, long long in_stride,
             const In* __restrict__ x1, long long x1_stride, int x1_rows,
             float* __restrict__ yr, float* __restrict__ yi,
             const float2* __restrict__ tw, int log2M, long long w_len,
             int a_crop, int strips) {
    extern __shared__ __align__(128) float smem[];
    if constexpr (PLANES)
        walk_cluster_strips<INVERSE, LOG2A>(
            reinterpret_cast<const float*>(x),
            reinterpret_cast<const float*>(x1), yr, yi, tw, log2M, a_crop,
            strips, smem);
    else
        walk_cluster_wire_strips<In, PAIR, LOG2A>(x, in_stride, x1, x1_stride,
                                                  x1_rows, yr, yi, tw, log2M,
                                                  w_len, strips, smem);
}

// Thread (col, u) = (tid mod C, tid / C) holds 16 points of column c =
// c0 + col of a strip of C columns; a persistent block walks the strips.
// PLANES: x, x1 are the two [P, A, M] f32 planes (walk_strips, one block
// per SM, so all of the SM's registers; the inverse, PLANES only, writes
// [P, a_crop, M]). Otherwise the wire passes (walk_wire_strips), 64
// registers a thread, as many blocks per SM as fit.
template <typename In, bool INVERSE, bool PAIR, bool PLANES, int LOG2A,
          bool WIDE>
__global__ void __launch_bounds__(threads_of(LOG2A),
                                  PLANES ? 1 : 1024 / threads_of(LOG2A))
major_pass(const In* __restrict__ x, long long in_stride,
           const In* __restrict__ x1, long long x1_stride, int x1_rows,
           float* __restrict__ yr, float* __restrict__ yi,
           const float2* __restrict__ tw, int log2M, long long w_len,
           int a_crop, int strips, const __grid_constant__ CUtensorMap out_r,
           const __grid_constant__ CUtensorMap out_i) {
    extern __shared__ __align__(128) float smem[];
    if constexpr (PLANES)
        walk_strips<INVERSE, LOG2A, WIDE>(reinterpret_cast<const float*>(x),
                                    reinterpret_cast<const float*>(x1), yr,
                                    yi, tw, log2M, a_crop, strips, smem);
    else
        walk_wire_strips<In, PAIR, LOG2A, WIDE>(x, in_stride, x1, x1_stride,
                                          x1_rows, yr, yi, &out_r, &out_i, tw,
                                          log2M, w_len, strips, smem);
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so that the library links against nothing more than libcudart.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* f = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
        if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(f);
    }
    return fn;
}

// The tensor map of one [P, A, M] f32 output plane for the wire passes'
// TMA stores: boxes of C columns by `box` rows of one plane. The plane must
// be 16-byte aligned (the wrappers check).
bool output_map(CUtensorMap* map, float* plane, int P, int log2A, int log2M,
                int C, int box) {
    const EncodeTiled encode = encode_tiled();
    if (!encode) return false;
    const cuuint64_t dims[3] = {1ull << log2M, 1ull << log2A,
                                (cuuint64_t)P};
    const cuuint64_t strides[2] = {4ull << log2M, 4ull << (log2A + log2M)};
    const cuuint32_t boxes[3] = {(cuuint32_t)C, (cuuint32_t)box, 1};
    const cuuint32_t steps[3] = {1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, plane, dims,
                  strides, boxes, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_NONE,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One instantiation's launch. Shared memory: the planes' passes 3 * (A +
// A/16) * C floats (raw and the one-plane tile), the cross twiddles and a
// float2 a thread; the wire passes WireLayout, with the tensor maps of their
// output planes where they store by TMA. The grid is the card's SMs times
// the blocks an SM holds, or the strips where there are fewer. The strips
// must number at least one and below 2^31.
template <typename In, bool INVERSE, bool PAIR, bool PLANES, int LOG2A,
          bool WIDE>
int launch_major_as(const In* x, long long in_stride, const In* x1,
                    long long x1_stride, int x1_rows, float* yr, float* yi,
                    const float2* tw, int P, int log2M, long long w_len,
                    int a_crop, cudaStream_t stream) {
    constexpr int LOG2C = strip_log2(LOG2A);
    using Wire = WireLayout<In, PAIR, LOG2A>;
    const long long strips = (long long)P << (log2M - LOG2C);
    if (strips > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    CUtensorMap out_r{}, out_i{};
    constexpr int C = 1 << LOG2C, BOX = Wire::BOX;
    if (!PLANES && Wire::TMA &&
        !(output_map(&out_r, yr, P, LOG2A, log2M, C, BOX) &&
          output_map(&out_i, yi, P, LOG2A, log2M, C, BOX)))
        return (int)cudaErrorInvalidValue;
    auto kern = major_pass<In, INVERSE, PAIR, PLANES, LOG2A, WIDE>;
    const size_t tile = ((1 << LOG2A) + (1 << LOG2A) / 16) << LOG2C;
    const size_t threads = threads_of(LOG2A);
    const size_t smem =
        PLANES ? (3 * tile + 2 * threads + (2 * (PTS + 1) << LOG2C)) *
                     sizeof(float)
               : (size_t)Wire::SMEM;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int dev = 0, sms = 0, per_sm = 1;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess && !PLANES)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kern, (int)threads, smem);
    if (err != cudaSuccess) return (int)err;
    const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
    const long long blocks = strips < fit ? strips : fit;
    kern<<<(unsigned)blocks, (unsigned)threads, smem, stream>>>(
        x, in_stride, x1, x1_stride, x1_rows, yr, yi, tw, log2M, w_len,
        a_crop, (int)strips, out_r, out_i);
    return (int)cudaGetLastError();
}

// A cluster pass's shared memory a block: the planes' raw (two planes),
// exchange tile, cross twiddles, cross bases and inner twiddles; the wire's
// WireLayout at A = 2048 and the inner twiddles.
template <typename In, bool PAIR, bool PLANES, int LOG2A>
constexpr size_t cluster_smem() {
    using Cl = Cluster<LOG2A>;
    return PLANES ? (size_t)(3 * Cl::TILE +
                             2 * (Cl::CT + Cl::THREADS + Cl::INNER)) *
                        sizeof(float)
                  : (size_t)WireLayout<In, PAIR, 11>::SMEM + 8 * Cl::INNER;
}

// A cluster pass's launch configuration (clusters of K blocks, its shared
// memory allowed) and the clusters the card holds at once at that shared
// memory: the grid of its persistent walk (cudaOccupancyMaxActiveClusters).
template <typename In, bool INVERSE, bool PAIR, bool PLANES, int LOG2A>
cudaError_t cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                           cudaStream_t stream, int* clusters) {
    using Cl = Cluster<LOG2A>;
    constexpr size_t smem = cluster_smem<In, PAIR, PLANES, LOG2A>();
    static_assert(smem <= MAX_SMEM, "the cluster pass's shared memory");
    auto kern = cluster_pass<In, INVERSE, PAIR, PLANES, LOG2A>;
    *clusters = 0;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = Cl::K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg->gridDim = dim3(Cl::K);
    cfg->blockDim = dim3(Cl::THREADS);
    cfg->dynamicSmemBytes = smem;
    cfg->stream = stream;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveClusters(clusters, kern, cfg);
    return err;
}

// A cluster pass's launch: the clusters the card holds (none: the launch
// is refused, cudaErrorLaunchOutOfResources), or fewer where there are
// fewer strips; its cudaLaunchKernelEx error or cudaGetLastError().
template <typename In, bool INVERSE, bool PAIR, bool PLANES, int LOG2A>
int launch_cluster(const In* x, long long in_stride, const In* x1,
                   long long x1_stride, int x1_rows, float* yr, float* yi,
                   const float2* tw, int P, int log2M, long long w_len,
                   int a_crop, cudaStream_t stream) {
    using Cl = Cluster<LOG2A>;
    const long long strips = (long long)P << (log2M - Cl::LOG2C);
    if (strips > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg{};
    cudaLaunchAttribute attr[1];
    int clusters = 0;
    cudaError_t err = cluster_config<In, INVERSE, PAIR, PLANES, LOG2A>(
        &cfg, attr, stream, &clusters);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
    const long long grid = strips < clusters ? strips : clusters;
    cfg.gridDim = dim3((unsigned)(grid * Cl::K));
    err = cudaLaunchKernelEx(&cfg, cluster_pass<In, INVERSE, PAIR, PLANES,
                                                LOG2A>,
                             x, in_stride, x1, x1_stride, x1_rows, yr, yi, tw,
                             log2M, w_len, a_crop, (int)strips);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// The instantiation for A = 2^log2A and the cross twiddle's form: root<true>
// above fft_len 2^24, root<false> up to 2^24 at A <= 4096 (A <= 1024 never
// passes 2^24: M is at most 16384, so it has root<false> alone); the
// cluster passes (root<true> whatever the fft_len) at A = 8192 and 16384.
template <typename In, bool INVERSE, bool PAIR, bool PLANES>
int launch_major(const In* x, long long in_stride, const In* x1,
                 long long x1_stride, int x1_rows, float* yr, float* yi,
                 const float2* tw, int P, int log2A, int log2M,
                 long long w_len, int a_crop, cudaStream_t stream) {
    if (!factor_fits(log2A) || !factor_fits(log2M) || P < 1)
        return (int)cudaErrorInvalidValue;
    return with_factor(log2A, [&](auto L) -> int {
        constexpr int LOG2A = decltype(L)::value;
        if constexpr (cluster_log2(LOG2A) > 0) {
            return launch_cluster<In, INVERSE, PAIR, PLANES, LOG2A>(
                x, in_stride, x1, x1_stride, x1_rows, yr, yi, tw, P, log2M,
                w_len, a_crop, stream);
        } else {
            auto go = [&](auto wide) {
                return launch_major_as<In, INVERSE, PAIR, PLANES, LOG2A,
                                       decltype(wide)::value>(
                    x, in_stride, x1, x1_stride, x1_rows, yr, yi, tw, P,
                    log2M, w_len, a_crop, stream);
            };
            if constexpr (LOG2A + MAX_LOG2_FACTOR <= 24)
                return go(std::false_type{});
            else
                return LOG2A + log2M > 24 ? go(std::true_type{})
                                          : go(std::false_type{});
        }
    });
}

// The clusters one instantiation's launch gets at A = 2^log2A (8192 or
// 16384): entry 0 = am_major_fwd_wire, 1 = am_major_fwd_wire2 (dtype as
// theirs), 2 = am_major_forward, 3 = am_major_inverse.
template <typename In>
int wire_clusters(int entry, int log2A, int* clusters) {
    cudaLaunchConfig_t cfg{};
    cudaLaunchAttribute attr[1];
    return with_factor(log2A, [&](auto L) -> int {
        constexpr int LOG2A = decltype(L)::value;
        if constexpr (cluster_log2(LOG2A) == 0) {
            return (int)cudaErrorInvalidValue;
        } else {
            switch (entry) {
                case 0:
                    return (int)cluster_config<In, false, false, false, LOG2A>(
                        &cfg, attr, 0, clusters);
                case 1:
                    return (int)cluster_config<In, false, true, false, LOG2A>(
                        &cfg, attr, 0, clusters);
                case 2:
                    return (int)cluster_config<float, false, true, true,
                                               LOG2A>(&cfg, attr, 0,
                                                      clusters);
                case 3:
                    return (int)cluster_config<float, true, false, true,
                                               LOG2A>(&cfg, attr, 0,
                                                      clusters);
                default:
                    return (int)cudaErrorInvalidValue;
            }
        }
    });
}

// dtype: 0 = uint8 (mulaw8 wire), 1 = int16, 2 = float32.
template <bool PAIR>
int launch_major_fwd_wire(int dtype, const void* x, long long in_stride,
                          const void* x1, long long x1_stride, int x1_rows,
                          float* yr, float* yi, const float2* tw, int P,
                          int log2A, int log2M, long long w_len,
                          cudaStream_t s) {
    switch (dtype) {
        case 0:
            return launch_major<uint8_t, false, PAIR, false>(
                (const uint8_t*)x, in_stride, (const uint8_t*)x1, x1_stride,
                x1_rows, yr, yi, tw, P, log2A, log2M, w_len, 0, s);
        case 1:
            return launch_major<int16_t, false, PAIR, false>(
                (const int16_t*)x, in_stride, (const int16_t*)x1, x1_stride,
                x1_rows, yr, yi, tw, P, log2A, log2M, w_len, 0, s);
        case 2:
            return launch_major<float, false, PAIR, false>(
                (const float*)x, in_stride, (const float*)x1, x1_stride,
                x1_rows, yr, yi, tw, P, log2A, log2M, w_len, 0, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

int am_major_fwd_wire(int dtype, const void* x, long long in_stride,
                      float* yr, float* yi, const float* tw, int P, int log2A,
                      int log2M, long long w_len, void* stream) {
    return launch_major_fwd_wire<false>(
        dtype, x, in_stride, nullptr, 0, 0, yr, yi, (const float2*)tw, P,
        log2A, log2M, w_len, (cudaStream_t)stream);
}

// fft(w0 + i*w1): row p of x0 is the real plane's window, row p of x1 (for
// p < x1_rows) the imaginary plane's; later rows pair with wire silence.
int am_major_fwd_wire2(int dtype, const void* x0, long long x0_stride,
                       const void* x1, long long x1_stride, int x1_rows,
                       float* yr, float* yi, const float* tw, int P,
                       int log2A, int log2M, long long w_len, void* stream) {
    return launch_major_fwd_wire<true>(
        dtype, x0, x0_stride, x1, x1_stride, x1_rows, yr, yi,
        (const float2*)tw, P, log2A, log2M, w_len, (cudaStream_t)stream);
}

// The forward major pass of complex f32 [P, A, M] planes (cross twiddle
// after the DIF).
int am_major_forward(const float* xr, const float* xi, float* yr, float* yi,
                     const float* tw, int P, int log2A, int log2M,
                     void* stream) {
    const long long n = 1LL << (log2A + log2M);
    return launch_major<float, false, true, true>(
        xr, n, xi, n, P, yr, yi, (const float2*)tw, P, log2A, log2M, n, 0,
        (cudaStream_t)stream);
}

int am_major_inverse(const float* xr, const float* xi, float* yr, float* yi,
                     const float* tw, int P, int log2A, int log2M, int a_crop,
                     void* stream) {
    if (a_crop < 1 || a_crop > (1 << log2A)) return (int)cudaErrorInvalidValue;
    return launch_major<float, true, false, true>(
        xr, 1LL << (log2A + log2M), xi, 0, 0, yr, yi, (const float2*)tw, P,
        log2A, log2M, 0, a_crop, (cudaStream_t)stream);
}

// The clusters the card holds at once for one cluster pass (the grid of its
// launches): entry 0 = am_major_fwd_wire, 1 = am_major_fwd_wire2, 2 =
// am_major_forward, 3 = am_major_inverse; dtype as the wire passes' (read
// by entries 0 and 1); log2A 13 or 14. 0 clusters: its launches are refused.
int am_major_clusters(int entry, int dtype, int log2A, int* clusters) {
    *clusters = 0;
    if (!factor_fits(log2A) || cluster_log2(log2A) == 0)
        return (int)cudaErrorInvalidValue;
    switch (entry < 2 ? dtype : 2) {
        case 0: return wire_clusters<uint8_t>(entry, log2A, clusters);
        case 1: return wire_clusters<int16_t>(entry, log2A, clusters);
        case 2: return wire_clusters<float>(entry, log2A, clusters);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
