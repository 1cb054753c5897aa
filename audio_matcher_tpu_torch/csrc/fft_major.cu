// The major FFT pass of the scans, for Hopper (sm_90a), on the core of
// fft_passes.cuh.
//
// Replaces the Pallas TPU kernels of audio_matcher_tpu/ops/pallas_fft.py:
//   major_pass<In, false, false, false, B> <- fft_major_fwd_wire
//   major_pass<In, false, true, false, B>  <- fft_major_fwd_wire2
//   major_pass<float, false, true, true, B>
//                               <- fft_major(inverse=False, cross=True)
//   major_pass<float, true, false, true, B>
//                               <- fft_major(inverse=True, cross=True, a_crop)
// one instantiation per A = 2^B, 2^7 .. 2^12.
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
// row, up to A = 512; 16 at 1024; 8 at 2048; 4 at 4096), 1024 threads of 64
// registers, one block per SM; the strip's tile holds the exchanges.
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
//  * The wire modes read 1 or 2 bytes a point: their loads are a quarter
//    or less of their stores. A block per strip loads its points straight
//    into registers, decodes them there and never materializes f32 windows.
//  * The cross twiddle keeps its exact integer exponent brev_A(r)*c: one
//    sincospif per thread and 16 per column of a strip (build_cross,
//    apply_cross), one complex product per point.
//  * Offsets into the planes are 64-bit: one plane of the product output
//    holds 2^30 elements. The planes run along gridDim.x with the strips.
//
// Each C entry point returns cudaGetLastError() of its launch, or
// cudaErrorInvalidValue for a factor it has no instantiation for.

#include "fft_passes.cuh"

namespace {

// log2 of the strip width: 2^14 points a block, 4 to 32 columns
// (ops/fft_plan.py's major_strip_log2). Narrower strips would write 16
// bytes of each 32-byte sector at A = 2048.
__host__ __device__ constexpr int strip_log2(int log2A) {
    return 14 - log2A > 5 ? 5 : 14 - log2A < 2 ? 2 : 14 - log2A;
}
// threads a block: C * A / 16 (1024 from A = 512 up)
__host__ __device__ constexpr int threads_of(int log2A) {
    return 1 << (strip_log2(log2A) + log2A - LOG2_PTS);
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

// A strided f32 load that asks L2 to fetch the whole 128-byte line from
// device memory: the strips of the neighbouring blocks, read at about the
// same time, find their sectors there.
__device__ __forceinline__ float load_line(const float* p) {
    float v;
    asm("ld.global.nc.L2::128B.f32 %0, [%1];" : "=f"(v) : "l"(p));
    return v;
}
template <typename In>
__device__ __forceinline__ In load_wire(const In* p) { return *p; }
template <>
__device__ __forceinline__ float load_wire<float>(const float* p) {
    return load_line(p);
}

// The wire code of silence: mu-law's zero is code 128, the others' is 0.
template <typename In>
__device__ __forceinline__ In wire_silence() { return In(0); }
template <>
__device__ __forceinline__ uint8_t wire_silence<uint8_t>() { return 128; }

// The cross twiddles W_n^{sign * e * D} of the strip's columns c0 + col,
// D = c * A/16, e < 16, at ct[col * 17 + e]: one sincospif of an exact
// integer exponent each (e * D < c * A < n).
template <int LOG2A, int LOG2C>
__device__ __forceinline__ void build_cross(float2* ct, int c0, int log2n,
                                            float sign) {
    for (int k = threadIdx.x; k < (PTS << LOG2C); k += blockDim.x) {
        const int col = k >> LOG2_PTS, e = k & (PTS - 1);
        ct[col * (PTS + 1) + e] =
            root(e * ((c0 + col) << (LOG2A - LOG2_PTS)), log2n, sign);
    }
}

// Multiply the thread's 16 points, rows a = (u << 4) | r of column c, by
// the cross twiddle W_n^{sign * brev_A(a) * c}. brev_A(a) = brev_A(u << 4)
// + brev_4(r) * A/16, so with the exact integer exponent K0 =
// brev_A(u << 4) * c it is base * ct[col][brev_4(r)] with base = W^{K0}
// (cross_base): one sincospif per thread and one product per point, not a
// sincospif per point.
template <int LOG2A>
__device__ __forceinline__ float2 cross_base(int u, int c, int log2n,
                                             float sign) {
    return root(brev_bits(u << LOG2_PTS, LOG2A) * c, log2n, sign);
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

// cp.async of 16 bytes, global -> shared, past L1; L2 fetches the whole
// 128-byte line.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
}

// Start the copy of strip s of the f32 planes (plane s / strips, columns
// c0 .. c0 + C) into raw: both planes, in the exchange tile's layout, so a
// thread reads its first group's points as from a tile. One commit group.
template <int LOG2A, int LOG2C>
__device__ __forceinline__ void fetch_strip(float* raw,
                                            const float* __restrict__ xr,
                                            const float* __restrict__ xi,
                                            int s, int log2M) {
    constexpr int PLANE = ((1 << LOG2A) + (1 << LOG2A) / 16) << LOG2C;
    constexpr int LOG2Q = LOG2C - 2;  // float4s per row of the strip
    constexpr int PER_PLANE = 1 << (LOG2A + LOG2Q);
    const int log2strips = log2M - LOG2C;
    const long long at = ((long long)(s >> log2strips) << (LOG2A + log2M)) +
                         ((s & ((1 << log2strips) - 1)) << LOG2C);
#pragma unroll 1
    for (int k = threadIdx.x; k < 2 * PER_PLANE; k += blockDim.x) {
        const int im = k >= PER_PLANE;
        const int kk = k - (im ? PER_PLANE : 0);
        const int a = kk >> LOG2Q, q = (kk & ((1 << LOG2Q) - 1)) << 2;
        cp_async16(raw + (im ? PLANE : 0) + ((a + (a >> 4)) << LOG2C) + q,
                   (im ? xi : xr) + at + ((long long)a << log2M) + q);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The f32 planes' passes: a persistent block walks strips s = blockIdx.x,
// + gridDim.x, ... of the P * M / C strips. The copy of the next strip into
// raw is in flight while the block runs the current strip's stages and
// stores; the exchanges go one plane at a time through the tile xt.
template <bool INVERSE, int LOG2A>
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
        build_cross<LOG2A, LOG2C>(ct, column(s) - col, log2n, sign);
        bases[threadIdx.x] = cross_base<LOG2A>(u, column(s), log2n, sign);
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

// The wire passes: one block per strip, blockIdx.x = p * (M / C) + strip,
// forward only. x is the real wire-dtype input, row p at x + p*in_stride,
// element (a, c) at a*M + c, read only below w_len (zero past it); output
// [P, A, M] planes. PAIR: the imaginary plane is read the same way from
// x1 + p*x1_stride for p < x1_rows; rows p >= x1_rows pair with wire
// silence (the pad window of an odd slab), decoded like any sample.
template <typename In, bool PAIR, int LOG2A>
__device__ __forceinline__ void wire_strip(
    const In* __restrict__ x, long long in_stride, const In* __restrict__ x1,
    long long x1_stride, int x1_rows, float* __restrict__ yr,
    float* __restrict__ yi, const float2* __restrict__ tw, int log2M,
    long long w_len, float* smem) {
    constexpr int A = 1 << LOG2A;
    constexpr int LOG2C = strip_log2(LOG2A);
    constexpr int TOP = LOG2A - LOG2_PTS;
    constexpr int PLANE = (A + A / 16) << LOG2C;
    const int log2n = LOG2A + log2M;
    const int log2strips = log2M - LOG2C;
    const long long p = blockIdx.x >> log2strips;
    const int col = threadIdx.x & ((1 << LOG2C) - 1);
    const int c = ((blockIdx.x & ((1 << log2strips) - 1)) << LOG2C) + col;
    const int u = threadIdx.x >> LOG2C;
    float* sr = smem;
    float* si = smem + PLANE;
    float* lut = smem + 2 * PLANE;  // the mu-law codes, decoded
    float2* ct = reinterpret_cast<float2*>(lut + 256);  // cross twiddles
    const MajorTile<LOG2C> tile{col};
    float vr[PTS], vi[PTS];

    if (sizeof(In) == 1)
        for (int v = threadIdx.x; v < 256; v += blockDim.x)
            lut[v] = dequant((uint8_t)v);
    build_cross<LOG2A, LOG2C>(ct, c - col, log2n, -1.0f);
    __syncthreads();
    auto decode = [lut](In v) {
        return sizeof(In) == 1 ? lut[(uint8_t)v] : dequant(v);
    };
    // rows a = u + r * A/16, read below w_len: a < a_end
    const long long first = ((long long)u << log2M) + c;
    const In* xp = x + p * in_stride + first;
    const bool x1_real = PAIR && p < x1_rows;
    const In* x1p = x1_real ? x1 + p * x1_stride + first : nullptr;
    const float x1_silence = PAIR ? decode(wire_silence<In>()) : 0.0f;
    const long long ends = (w_len - c + (1LL << log2M) - 1) >> log2M;
    const int a_end = (int)(ends < 0 ? 0 : ends < A ? ends : A);
    const int step = 1 << (TOP + log2M);  // A/16 rows, n/16 elements
#pragma unroll
    for (int r = 0; r < PTS; ++r) {
        const bool in = u + (r << TOP) < a_end;
        vr[r] = in ? decode(load_wire(xp + r * step)) : 0.0f;
        if (PAIR)
            vi[r] = in ? (x1_real ? decode(load_wire(x1p + r * step))
                                  : x1_silence)
                       : 0.0f;
        else
            vi[r] = 0.0f;
    }
    transform<true, true, LOG2A>(vr, vi, sr, si, tile, u, tw);
    // physical row a holds frequency brev(a): twiddle W_n^{brev(a)*c}; the
    // block's place again (opaque), not held across the stages
    const int bid = opaque(blockIdx.x), tid = opaque(threadIdx.x);
    const int c2 = ((bid & ((1 << log2strips) - 1)) << LOG2C) +
                   (tid & ((1 << LOG2C) - 1));
    const int u2 = tid >> LOG2C;
    apply_cross(vr, vi, cross_base<LOG2A>(u2, c2, log2n, -1.0f),
                ct + (tid & ((1 << LOG2C) - 1)) * (PTS + 1));
    store_forward(vr, vi, yr, yi,
                  ((long long)(bid >> log2strips) << log2n) +
                      ((long long)u2 << (log2M + 4)) + c2,
                  log2M);
}

// Thread (col, u) = (tid mod C, tid / C) holds 16 points of column c =
// c0 + col of a strip of C columns. PLANES: x, x1 are the two [P, A, M]
// f32 planes (walk_strips, at most one block per SM, so all of the SM's
// registers; the inverse, PLANES only, writes [P, a_crop, M]). Otherwise
// the wire passes (wire_strip), 64 registers a thread.
template <typename In, bool INVERSE, bool PAIR, bool PLANES, int LOG2A>
__global__ void __launch_bounds__(threads_of(LOG2A),
                                  PLANES ? 1 : 1024 / threads_of(LOG2A))
major_pass(const In* __restrict__ x, long long in_stride,
           const In* __restrict__ x1, long long x1_stride, int x1_rows,
           float* __restrict__ yr, float* __restrict__ yi,
           const float2* __restrict__ tw, int log2M, long long w_len,
           int a_crop, int strips) {
    extern __shared__ float smem[];
    if constexpr (PLANES)
        walk_strips<INVERSE, LOG2A>(reinterpret_cast<const float*>(x),
                                    reinterpret_cast<const float*>(x1), yr,
                                    yi, tw, log2M, a_crop, strips, smem);
    else
        wire_strip<In, PAIR, LOG2A>(x, in_stride, x1, x1_stride, x1_rows, yr,
                                    yi, tw, log2M, w_len, smem);
}

// Shared memory: the wire passes 2 * (A + A/16) * C floats of tile, 256 of
// the mu-law decode table and C * 17 float2 of cross twiddles; the planes'
// passes 3 * (A + A/16) * C floats (raw and the one-plane tile), the cross
// twiddles and a float2 a thread, at most one block per SM walking the
// strips. The strips
// must number at least one and below 2^31.
template <typename In, bool INVERSE, bool PAIR, bool PLANES>
int launch_major(const In* x, long long in_stride, const In* x1,
                 long long x1_stride, int x1_rows, float* yr, float* yi,
                 const float2* tw, int P, int log2A, int log2M,
                 long long w_len, int a_crop, cudaStream_t stream) {
    if (!factor_fits(log2A) || !factor_fits(log2M) || P < 1)
        return (int)cudaErrorInvalidValue;
    return with_factor(log2A, [&](auto L) {
        constexpr int LOG2A = decltype(L)::value;
        constexpr int LOG2C = strip_log2(LOG2A);
        const long long strips = (long long)P << (log2M - LOG2C);
        if (strips > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
        auto kern = major_pass<In, INVERSE, PAIR, PLANES, LOG2A>;
        const size_t tile = ((1 << LOG2A) + (1 << LOG2A) / 16) << LOG2C;
        const size_t threads = threads_of(LOG2A);
        const size_t own = PLANES ? 3 * tile + 2 * threads : 2 * tile + 256;
        const size_t smem = (own + (2 * (PTS + 1) << LOG2C)) * sizeof(float);
        cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        long long blocks = strips;
        if (PLANES) {
            int dev = 0, sms = 0;
            err = cudaGetDevice(&dev);
            if (err == cudaSuccess)
                err = cudaDeviceGetAttribute(
                    &sms, cudaDevAttrMultiProcessorCount, dev);
            if (err != cudaSuccess) return (int)err;
            blocks = strips < sms ? strips : sms;
        }
        kern<<<(unsigned)blocks, (unsigned)threads, smem, stream>>>(
            x, in_stride, x1, x1_stride, x1_rows, yr, yi, tw, log2M, w_len,
            a_crop, (int)strips);
        return (int)cudaGetLastError();
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

}  // extern "C"
