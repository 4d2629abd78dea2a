// Gram backward for Hopper (sm_90a): dF = F @ g, on the tensor cores.
//
// Replaces the TPU kernel artstyletransfer_tpu/ops/pallas_kernels.py
// `_gram_bwd_kernel` (driven by `_gram_bwd_impl` / `_gram_vjp_bwd`, which
// vmap it over the batch). Per lane of a batch: F is the (n, c) row-major
// feature matrix (float32 or bfloat16), g a (c, c) float32 matrix, dF
// (n, c) in F's dtype; the lanes are stacked as (B, n, c), (B, c, c) and
// (B, n, c), and one launch serves them all (blockIdx.z is the lane). The
// one kernel serves both backward formulas of the port: the Gram's own
// VJP, g = s(G_bar + G_bar^T), and the fused style-layer loss,
// g = (D + D^T) 2s/(c^3 h w). Both are symmetric; the kernel does not
// assume it. c must be a multiple of 8 (VGG19's taps are 64-512).
//
// Bounds on the H100, per lane, with e the bytes of one F value:
// - bytes: 2*n*c*e + 4*c^2 over 3.35 TB/s;
// - on CUDA-core FMAs: 2*n*c^2 FLOPs over 67 TFLOP/s (bytes bind at c = 64,
//   FLOPs from c = 128 up);
// - on the tensor cores, as here: 3 * 2*n*c^2 TF32 operations over
//   495 TFLOP/s, i.e. float32 work at 165 TFLOP/s (bytes bind at c <= 128,
//   operations from c = 256 up).
//
// Design:
// - 3xTF32. One TF32 product keeps 10 mantissa bits (~5e-4 relative per
//   rounding), too coarse for float32 gradients. Each float32 operand x is
//   split into x_hi = tf32(x), rounded to nearest, and x_lo = x - x_hi, and
//   a_lo*b_hi + a_hi*b_lo + a_hi*b_hi is accumulated in float32 by
//   mma.sync m16n8k8 (the dropped a_lo*b_lo lies below float32 rounding).
//   The rounding is two integer operations (see split()). A bfloat16 value
//   is exact in TF32: for bfloat16 F, a_lo is 0 and its product is skipped.
// - Tiles: 4 warps own a 128 x 64 tile of dF (each warp 32 x 64, 2 x 8 MMA
//   tiles, 64 float32 accumulators per thread) and walk K = c in 32-wide
//   chunks. Where that grid would have fewer blocks than the card has SMs
//   (the 1024- and 256-row taps of one lane), 64 x 64 tiles (warps of
//   32 x 32) run instead. mma.sync issues from the warp's own instruction
//   stream, so the tile sizes were chosen by measuring: on the H100 the
//   compute-bound shapes run at about a third of the TF32 tensor-core
//   peak, bound by instruction issue (wgmma, not used here, is the way
//   past it).
// - Loads: F and g chunks come through a ring of 16-byte cp.async.cg copies
//   (3 stages, 4 for the small tile; zero-filled past the ragged edges),
//   with one __syncthreads per chunk; row strides are padded so that each
//   MMA fragment read hits 32 distinct banks.
// - L2: the c/64 column blocks of one row slab are consecutive in
//   blockIdx.x, so they run together and F's re-reads hit L2.
// - Epilogue: the tile is staged through shared memory and written with
//   16-byte stores (4 floats or 8 bfloat16 per thread).
// - Each output is one thread's fixed-order sum over K: no split over K,
//   no atomics, the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

// A block's tile of dF: WM x WN warps, each owning MT x NT MMA tiles of
// 16 x 8 (32 x 32 at MT = 2, NT = 4); K walked in BK-wide chunks through
// a ring of STAGES buffers.
template <int WM, int WN, int MT, int NT, int BK_, int STAGES_>
struct Tile {
    static constexpr int kWM = WM, kWN = WN, kMT = MT, kNT = NT;
    static constexpr int BM = WM * 16 * MT;
    static constexpr int BN = WN * 8 * NT;
    static constexpr int BK = BK_;
    static constexpr int kStages = STAGES_;
    static constexpr int kThreads = 32 * WM * WN;
    // row stride (floats) of a g chunk and of the staged dF tile
    static constexpr int kStride = BN + 8;
    // F chunk row stride in elements: BK + 4 floats or BK + 8 bfloat16
    template <typename T>
    __host__ __device__ static constexpr int a_stride() {
        return BK + 16 / static_cast<int>(sizeof(T));
    }
    template <typename T>
    __host__ __device__ static constexpr int smem_bytes() {
        constexpr int ring =
            kStages * (BM * a_stride<T>() * static_cast<int>(sizeof(T)) +
                       BK * kStride * 4);
        constexpr int staged = BM * kStride * 4;
        return ring > staged ? ring : staged;
    }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

// x = hi + lo: hi is x rounded to TF32, to nearest with ties away from
// zero (cvt.rna's rounding, as two integer operations: sm_90 has no single
// instruction for cvt.rna.tf32.f32, which compiles to a range-checked
// sequence); lo = x - hi is exact in float32, and the tensor core reads
// its top 10 mantissa bits (truncation), 2^-21 of x at most.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a * b, a 16x8 (row), b 8x8 (col), TF32 in, float32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One K chunk [k0, k0 + BK): F rows [row0, row0 + BM) and g columns
// [col0, col0 + BN), zero past n and c (c % 8 == 0: no 16-byte copy
// straddles an edge).
template <class TL, typename T>
__device__ __forceinline__ void load_chunk(T* a_s, float* b_s, const T* f,
                                           const float* g, int n, int c,
                                           int row0, int col0, int k0,
                                           int tid) {
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kAPerRow = TL::BK / kVec;
    constexpr int kAStride = TL::template a_stride<T>();
    static_assert(TL::BM * kAPerRow % TL::kThreads == 0, "whole copies");
#pragma unroll
    for (int j = 0; j < TL::BM * kAPerRow / TL::kThreads; ++j) {
        const int i = tid + j * TL::kThreads;
        const int r = i / kAPerRow;
        const int kk = (i % kAPerRow) * kVec;
        const int row = row0 + r;
        const int k = k0 + kk;
        const bool ok = row < n && k < c;
        cp_async16(a_s + r * kAStride + kk,
                   ok ? f + static_cast<size_t>(row) * c + k : f, ok ? 16 : 0);
    }
    constexpr int kBPerRow = TL::BN / 4;
    static_assert(TL::BK * kBPerRow % TL::kThreads == 0, "whole copies");
#pragma unroll
    for (int j = 0; j < TL::BK * kBPerRow / TL::kThreads; ++j) {
        const int i = tid + j * TL::kThreads;
        const int kk = i / kBPerRow;
        const int nn = (i % kBPerRow) * 4;
        const int k = k0 + kk;
        const int col = col0 + nn;
        const bool ok = k < c && col < c;
        cp_async16(b_s + kk * TL::kStride + nn,
                   ok ? g + static_cast<size_t>(k) * c + col : g, ok ? 16 : 0);
    }
}

__device__ __forceinline__ void store16(float* dst, const float* src) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
// two floats as a bfloat16 pair (round to nearest even), a first in memory
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* src) {
    const float4 lo = *reinterpret_cast<const float4*>(src);
    const float4 hi = *reinterpret_cast<const float4*>(src + 4);
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                   pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
}

template <class TL, typename T>
__global__ void __launch_bounds__(TL::kThreads)
gram_bwd_kernel(const T* __restrict__ f, const float* __restrict__ g, int n,
                int c, T* __restrict__ df) {
    constexpr bool kSplitA = std::is_same<T, float>::value;
    constexpr int MT = TL::kMT, NT = TL::kNT, BK = TL::BK;
    constexpr int kStages = TL::kStages;
    constexpr int kAStride = TL::template a_stride<T>();
    constexpr int kStride = TL::kStride;
    constexpr int kASize = TL::BM * kAStride, kBSize = BK * kStride;
    extern __shared__ __align__(16) unsigned char smem[];
    T* a_ring = reinterpret_cast<T*>(smem);
    float* b_ring =
        reinterpret_cast<float*>(smem + kStages * kASize * sizeof(T));

    // column blocks of one row slab are neighbours in x (L2 reuse of F)
    const int col_blocks = (c + TL::BN - 1) / TL::BN;
    const int col0 = (blockIdx.x % col_blocks) * TL::BN;
    const int row0 = (blockIdx.x / col_blocks) * TL::BM;
    const size_t lane = blockIdx.z;
    f += lane * n * c;
    g += lane * c * c;
    df += lane * n * c;

    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int wm = (warp / TL::kWN) * 16 * MT;  // warp's rows in the tile
    const int wn = (warp % TL::kWN) * 8 * NT;   // warp's columns in the tile
    const int gq = (tid % 32) / 4;              // MMA fragment group
    const int tq = tid % 4;                     // thread in group

    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

    const int chunks = (c + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < chunks)
            load_chunk<TL>(a_ring + s * kASize, b_ring + s * kBSize, f, g, n,
                           c, row0, col0, s * BK, tid);
        cp_async_commit();
    }

    for (int kt = 0; kt < chunks; ++kt) {
        cp_async_wait<kStages - 2>();  // chunk kt has landed (this thread)
        __syncthreads();               // ... for all; chunk kt-1 consumed
        const int next = kt + kStages - 1;
        if (next < chunks) {
            const int s = next % kStages;
            load_chunk<TL>(a_ring + s * kASize, b_ring + s * kBSize, f, g, n,
                           c, row0, col0, next * BK, tid);
        }
        cp_async_commit();

        const T* a_s = a_ring + (kt % kStages) * kASize;
        const float* b_s = b_ring + (kt % kStages) * kBSize;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 8) {
            // B fragments: (k t, column g), (t+4, g)
            uint32_t b_hi[NT][2], b_lo[NT][2];
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const float* p = b_s + (kk + tq) * kStride + wn + 8 * j + gq;
                split(p[0], b_hi[j][0], b_lo[j][0]);
                split(p[4 * kStride], b_hi[j][1], b_lo[j][1]);
            }
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                // A fragment: (row g, k t), (g+8, t), (g, t+4), (g+8, t+4)
                const T* p = a_s + (wm + 16 * i + gq) * kAStride + kk + tq;
                const float x[4] = {to_float(p[0]), to_float(p[8 * kAStride]),
                                    to_float(p[4]),
                                    to_float(p[8 * kAStride + 4])};
                uint32_t a_hi[4], a_lo[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    if constexpr (kSplitA) {
                        split(x[r], a_hi[r], a_lo[r]);
                    } else {
                        a_hi[r] = __float_as_uint(x[r]);  // exact in TF32
                    }
                }
                // small products first, the large one last
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                    if constexpr (kSplitA) mma(acc[i][j], a_lo, b_hi[j]);
                    mma(acc[i][j], a_hi, b_lo[j]);
                    mma(acc[i][j], a_hi, b_hi[j]);
                }
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring: reuse it

    // C fragments: (row g, columns 2t, 2t+1) and (g+8, 2t, 2t+1)
    float* c_s = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            float* p =
                c_s + (wm + 16 * i + gq) * kStride + wn + 8 * j + 2 * tq;
            *reinterpret_cast<float2*>(p) =
                make_float2(acc[i][j][0], acc[i][j][1]);
            *reinterpret_cast<float2*>(p + 8 * kStride) =
                make_float2(acc[i][j][2], acc[i][j][3]);
        }
    __syncthreads();

    constexpr int kVec = 16 / sizeof(T);  // outputs per 16-byte store
    constexpr int kPerRow = TL::BN / kVec;
    static_assert(TL::BM * kPerRow % TL::kThreads == 0, "whole stores");
#pragma unroll
    for (int j = 0; j < TL::BM * kPerRow / TL::kThreads; ++j) {
        const int i = tid + j * TL::kThreads;
        const int r = i / kPerRow;
        const int cc = (i % kPerRow) * kVec;
        const int row = row0 + r;
        const int col = col0 + cc;
        if (row < n && col < c)
            store16(df + static_cast<size_t>(row) * c + col,
                    c_s + r * kStride + cc);
    }
}

template <class TL, typename T>
int launch_tile(const void* f, const float* g, int batch, int n, int c,
                void* df, cudaStream_t stream) {
    constexpr int bytes = TL::template smem_bytes<T>();
    const cudaError_t err = cudaFuncSetAttribute(
        gram_bwd_kernel<TL, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned blocks = static_cast<unsigned>((n + TL::BM - 1) / TL::BM) *
                            static_cast<unsigned>((c + TL::BN - 1) / TL::BN);
    const dim3 grid(blocks, 1, batch);
    gram_bwd_kernel<TL, T><<<grid, TL::kThreads, bytes, stream>>>(
        static_cast<const T*>(f), g, n, c, static_cast<T*>(df));
    return static_cast<int>(cudaGetLastError());
}

// 128 x 64 tiles of 4 warps of 32 x 64 (2 blocks per SM), and 64 x 64
// tiles of 4 warps of 32 x 32 with a 4-stage ring for grids that the large
// tile would leave with fewer blocks than SMs (the 1024- and 256-row taps)
using LargeTile = Tile<4, 1, 2, 8, 32, 3>;
using SmallTile = Tile<2, 2, 2, 4, 32, 4>;

template <typename T>
int launch(const void* f, const float* g, int batch, int n, int c, void* df,
           cudaStream_t stream) {
    if (batch < 1 || n < 1 || c < 8 || c % 8 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long large =
        static_cast<long long>((n + LargeTile::BM - 1) / LargeTile::BM) *
        ((c + LargeTile::BN - 1) / LargeTile::BN) * batch;
    if (large >= sms)
        return launch_tile<LargeTile, T>(f, g, batch, n, c, df, stream);
    return launch_tile<SmallTile, T>(f, g, batch, n, c, df, stream);
}

}  // namespace

extern "C" {

// f, df: (batch, n, c) row-major, dtype 0 = float32, 1 = bfloat16;
// g: (batch, c, c) float32; every pointer 16-byte aligned, c % 8 == 0.
// Returns the cudaError_t of the launch (0 = success).
int astt_gram_bwd(const void* f, int dtype, const float* g, int batch, int n,
                  int c, void* df, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(f, g, batch, n, c, df, s);
    if (dtype == 1) return launch<__nv_bfloat16>(f, g, batch, n, c, df, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
