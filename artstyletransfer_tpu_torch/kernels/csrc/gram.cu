// Gram forward for Hopper (sm_90a): G = s * F^T F, on the tensor cores.
//
// Replaces the TPU kernel artstyletransfer_tpu/ops/pallas_kernels.py
// `_gram_kernel` (driven by `_gram_fwd_impl`, which vmaps it over the
// batch). F is a (B, n, c) row-major stack of feature matrices, one per
// lane (an NHWC tap, n = h*w), float32 or bfloat16; G is (B, c, c)
// float32. One launch serves every lane: the lane is blockIdx.z. c must be
// a multiple of 8 (VGG19's taps are 64-512).
//
// Bounds on the H100, per lane, with e the bytes of one F value (G is
// symmetric: only its upper triangle, c*(c+1)/2 dot products of length n,
// is work):
// - bytes: n*c*e over 3.35 TB/s (the (c, c) output is small beside it);
// - on CUDA-core FMAs: n*c*(c+1) FLOPs over 67 TFLOP/s (bytes bind at
//   c = 64, FLOPs from c = 128 up);
// - on the tensor cores, as here: 3 * n*c*(c+1) TF32 operations (1 * for
//   bfloat16 F) over 495 TFLOP/s (in float32, bytes bind at c = 64 and
//   operations from c = 128 up).
//
// Design:
// - Split over rows. The TPU kernel carries its sum through a sequential
//   grid; here blocks run in parallel, so the grid is (upper-triangular
//   output tiles, ti <= tj) x (row splits) x (lanes). Each block writes its
//   tile's partial sum into its own (c, c) slice of a (B, splits, c, c)
//   workspace, and a second kernel sums each lane's slices in a fixed
//   order, scales by s and writes both triangles: deterministic, no
//   atomics. The wrapper (kernels/gram.py::split_plan) sizes the splits
//   for at most three waves of blocks and at most 256 splits.
// - Operands from one staged chunk. A chunk is BK rows of F for the tile's
//   columns, row-major (k-major) in shared memory; both MMA operands read
//   it: A(i, k) = F[k][i] and B(k, j) = F[k][j]. The row stride is padded
//   to 8 (mod 32) words, so each fragment read hits 32 distinct banks. A
//   diagonal tile stages its one column slab, not two; its warps wholly
//   below the diagonal skip the MMAs (the second pass mirrors the upper
//   triangle), and a warp whose rows are its columns takes its B fragments
//   from its A fragments (an A fragment of 16 rows holds the B fragments
//   of two 8-column tiles) and skips its MMA tiles below the diagonal.
// - 3xTF32, as in gram_bwd.cu. Each float32 value x is split into
//   x_hi = tf32(x), rounded to nearest, and x_lo = x - x_hi, and
//   a_lo*b_hi + a_hi*b_lo + a_hi*b_hi is accumulated in float32 by
//   mma.sync m16n8k8: about float32 accuracy, which the loss needs, since
//   it takes G - Gt, small late in a run (one TF32 product keeps 10
//   mantissa bits). A bfloat16 value is exact in TF32: for bfloat16 F both
//   low parts are 0, and one product per MMA tile remains. Each chunk's
//   products are summed from zero and then added to the block's sum in
//   float32: the tensor core's accumulation does not round to nearest,
//   and over a whole split (up to 1024+ rows) its error grew to 7.6e-6 of
//   the float64 Gram, against 3.3e-7 with the chunked sum.
// - Tiles: 64 x 64 tiles of 4 warps of 32 x 32, three blocks per SM.
//   128 x 128 tiles of 8 warps of 32 x 64 (4x instead of 8x re-reads of F
//   at c = 512) were measured and gained nothing over the 64 x 64 tiles
//   at more splits. The warps' places in the tile rotate from block to
//   block, so that the unequal work of a diagonal tile's places spreads
//   over the SM's sub-partitions.
// - Loads: a 4-stage ring of 16-byte cp.async.cg copies, BK = 32 rows per
//   chunk, one __syncthreads per chunk, zero-filled past the split's last
//   row and past c.
// - Epilogue: each block stages its tile through shared memory and
//   writes it with 16-byte stores; the second pass reads the upper
//   triangle only and writes each value at (i, j) and, through shared
//   memory in rows, at (j, i).
// - On the H100 the float32 shapes run at about a third of the TF32 peak
//   in mma.sync issue (as gram_bwd.cu): wgmma is the way past it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

// A block's square tile of G: WM x WN warps, each owning MT x NT MMA tiles
// of 16 x 8 (32 x 32 at MT = 2, NT = 4); the rows of F walked in BK-row
// chunks through a ring of STAGES buffers, each one or two column slabs.
template <int WM, int WN, int MT, int NT, int BK_, int STAGES_>
struct Tile {
    static constexpr int kWM = WM, kWN = WN, kMT = MT, kNT = NT;
    static constexpr int BM = WM * 16 * MT;
    static constexpr int BN = WN * 8 * NT;
    static_assert(BM == BN, "square tiles of G");
    static constexpr int BK = BK_;
    static constexpr int kStages = STAGES_;
    static constexpr int kThreads = 32 * WM * WN;
    // row stride (floats) of the staged output tile
    static constexpr int kOutStride = BN + 8;
    // row stride of a slab in elements: BN + 8 floats or BN + 16 bfloat16,
    // 8 (mod 32) words either way
    template <typename T>
    __host__ __device__ static constexpr int stride() {
        return BN + 32 / static_cast<int>(sizeof(T));
    }
    template <typename T>
    __host__ __device__ static constexpr int slab() {
        return BK * stride<T>();
    }
    template <typename T>
    __host__ __device__ static constexpr int smem_bytes() {
        constexpr int ring =
            kStages * 2 * slab<T>() * static_cast<int>(sizeof(T));
        constexpr int staged = BM * kOutStride * 4;
        return ring > staged ? ring : staged;
    }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

// x = hi + lo: hi is x rounded to TF32, to nearest with ties away from
// zero (cvt.rna's rounding, as two integer operations); lo = x - hi is
// exact in float32, and the tensor core reads its top 10 mantissa bits.
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

// One slab: F rows [row0, row0 + BK) x columns [col0, col0 + BN), zero at
// rows >= row_end and columns >= c (c % 8 == 0: no 16-byte copy straddles
// the edge)
template <class TL, typename T>
__device__ __forceinline__ void load_slab(T* s, const T* f, int c, int row0,
                                          int row_end, int col0, int tid) {
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kPerRow = TL::BN / kVec;
    constexpr int kStride = TL::template stride<T>();
    static_assert(TL::BK * kPerRow % TL::kThreads == 0, "whole copies");
#pragma unroll
    for (int j = 0; j < TL::BK * kPerRow / TL::kThreads; ++j) {
        const int i = tid + j * TL::kThreads;
        const int r = i / kPerRow;
        const int cc = (i % kPerRow) * kVec;
        const int row = row0 + r;
        const int col = col0 + cc;
        const bool ok = row < row_end && col < c;
        cp_async16(s + r * kStride + cc,
                   ok ? f + static_cast<size_t>(row) * c + col : f,
                   ok ? 16 : 0);
    }
}

// Ring slot s of one chunk: the A slab (columns col_a) at 2s and, unless
// the tile is diagonal, the B slab (columns col_b) at 2s + 1
template <class TL, typename T>
__device__ __forceinline__ void load_stage(T* ring, int s, const T* f, int c,
                                           int row0, int row_end, int col_a,
                                           int col_b, bool diag, int tid) {
    constexpr int kSlab = TL::template slab<T>();
    load_slab<TL>(ring + 2 * s * kSlab, f, c, row0, row_end, col_a, tid);
    if (!diag)
        load_slab<TL>(ring + (2 * s + 1) * kSlab, f, c, row0, row_end, col_b,
                      tid);
}

// The warp's MMAs over one staged chunk. A fragment of MMA tile i: (row g,
// k t), (g+8, t), (g, t+4), (g+8, t+4) at a_s[(k) * stride + column]; B
// fragment of tile j: (k t, column g), (t+4, g). kSelf: the warp's columns
// are its rows, and its B fragments are taken from its A fragments.
template <class TL, bool kSelf, typename T>
__device__ __forceinline__ void mma_chunk(
    float (&acc)[TL::kMT][TL::kNT][4], const T* a_s, const T* b_s, int wm,
    int wn, int gq, int tq) {
    constexpr bool kSplit = std::is_same<T, float>::value;
    constexpr int MT = TL::kMT, NT = TL::kNT;
    constexpr int S = TL::template stride<T>();
    static_assert(!kSelf || NT == 2 * MT, "B from A needs square warps");
#pragma unroll
    for (int kk = 0; kk < TL::BK; kk += 8) {
        uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
            const T* p = a_s + (kk + tq) * S + wm + 16 * i + gq;
            const float x[4] = {to_float(p[0]), to_float(p[8]),
                                to_float(p[4 * S]), to_float(p[4 * S + 8])};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                if constexpr (kSplit) {
                    split(x[r], a_hi[i][r], a_lo[i][r]);
                } else {
                    a_hi[i][r] = __float_as_uint(x[r]);  // exact in TF32
                }
            }
        }
        uint32_t b_hi[NT][2], b_lo[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            if constexpr (kSelf) {
                // columns 16*(j/2) + 8*(j%2) + g are the A rows g (+8)
                b_hi[j][0] = a_hi[j / 2][j % 2];
                b_hi[j][1] = a_hi[j / 2][2 + j % 2];
                if constexpr (kSplit) {
                    b_lo[j][0] = a_lo[j / 2][j % 2];
                    b_lo[j][1] = a_lo[j / 2][2 + j % 2];
                }
            } else {
                const T* p = b_s + (kk + tq) * S + wn + 8 * j + gq;
                if constexpr (kSplit) {
                    split(to_float(p[0]), b_hi[j][0], b_lo[j][0]);
                    split(to_float(p[4 * S]), b_hi[j][1], b_lo[j][1]);
                } else {
                    b_hi[j][0] = __float_as_uint(to_float(p[0]));
                    b_hi[j][1] = __float_as_uint(to_float(p[4 * S]));
                }
            }
        }
        // small products first, the large one last
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                if (kSelf && 16 * i >= 8 * j + 8) continue;  // below diagonal
                if constexpr (kSplit) {
                    mma(acc[i][j], a_lo[i], b_hi[j]);
                    mma(acc[i][j], a_hi[i], b_lo[j]);
                }
                mma(acc[i][j], a_hi[i], b_hi[j]);
            }
    }
}

// three blocks per SM (what the float32 ring's shared memory allows); the
// bound also keeps ptxas from capping the registers below what the
// bfloat16 instance needs without spilling
template <class TL, typename T>
__global__ void __launch_bounds__(TL::kThreads, 3)
gram_partial_kernel(const T* __restrict__ f, int n, int c, int n_tiles,
                    int rows_per_split, float* __restrict__ part) {
    constexpr int MT = TL::kMT, NT = TL::kNT, BK = TL::BK;
    constexpr int kStages = TL::kStages;
    constexpr int kSlab = TL::template slab<T>();
    extern __shared__ __align__(16) unsigned char smem[];
    T* ring = reinterpret_cast<T*>(smem);

    // blockIdx.x enumerates the tiles (ti, tj), ti <= tj, row by row
    int t = blockIdx.x;
    int ti = 0;
    int row_len = n_tiles;
    while (t >= row_len) {
        t -= row_len;
        ++ti;
        --row_len;
    }
    const int tj = ti + t;
    const bool diag = ti == tj;
    const int col_a = ti * TL::BM;
    const int col_b = tj * TL::BN;

    const int split = blockIdx.y;
    const size_t lane = blockIdx.z;
    f += lane * n * c;
    const int r_begin = split * rows_per_split;
    const int r_end = min(n, r_begin + rows_per_split);

    const int tid = threadIdx.x;
    // the warps' places in the tile rotate from block to block: on a
    // diagonal tile the places carry unequal work, and a warp's number
    // fixes the SM sub-partition (and tensor core) that runs it
    const int place =
        (tid / 32 + blockIdx.x + blockIdx.y) % (TL::kWM * TL::kWN);
    const int wm = (place / TL::kWN) * 16 * MT;  // warp's rows in the tile
    const int wn = (place % TL::kWN) * 8 * NT;   // warp's columns in the tile
    const int gq = (tid % 32) / 4;              // MMA fragment group
    const int tq = tid % 4;                     // thread in group
    // on a diagonal tile: a warp wholly below the diagonal has no work, and
    // a warp on it reads B from its own A fragments
    const bool idle = diag && wm >= wn + 8 * NT;
    const bool self = diag && wm == wn;

    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

    const int chunks = r_end > r_begin ? (r_end - r_begin + BK - 1) / BK : 0;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < chunks)
            load_stage<TL>(ring, s, f, c, r_begin + s * BK, r_end, col_a,
                           col_b, diag, tid);
        cp_async_commit();
    }

    for (int kt = 0; kt < chunks; ++kt) {
        cp_async_wait<kStages - 2>();  // chunk kt has landed (this thread)
        __syncthreads();               // ... for all; chunk kt-1 consumed
        const int next = kt + kStages - 1;
        if (next < chunks)
            load_stage<TL>(ring, next % kStages, f, c, r_begin + next * BK,
                           r_end, col_a, col_b, diag, tid);
        cp_async_commit();

        if (idle) continue;
        // the chunk's sum starts from zero and is added to acc in float32:
        // the tensor core's accumulation does not round to nearest, and
        // its error would grow with the length of the split
        float part_acc[MT][NT][4] = {};
        const T* a_s = ring + 2 * (kt % kStages) * kSlab;
        const T* b_s = diag ? a_s : a_s + kSlab;
        if (self)
            mma_chunk<TL, true>(part_acc, a_s, b_s, wm, wn, gq, tq);
        else
            mma_chunk<TL, false>(part_acc, a_s, b_s, wm, wn, gq, tq);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int r = 0; r < 4; ++r) acc[i][j][r] += part_acc[i][j][r];
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring: reuse it

    // C fragments: (row g, columns 2t, 2t+1) and (g+8, 2t, 2t+1)
    constexpr int kOut = TL::kOutStride;
    float* c_s = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            float* p = c_s + (wm + 16 * i + gq) * kOut + wn + 8 * j + 2 * tq;
            *reinterpret_cast<float2*>(p) =
                make_float2(acc[i][j][0], acc[i][j][1]);
            *reinterpret_cast<float2*>(p + 8 * kOut) =
                make_float2(acc[i][j][2], acc[i][j][3]);
        }
    __syncthreads();

    // the tile into this split's slice, 16-byte stores (an idle warp's
    // zeros lie below the diagonal, which the second pass never reads)
    float* out = part + (lane * gridDim.y + split) * c * c;
    constexpr int kPerRow = TL::BN / 4;
    static_assert(TL::BM * kPerRow % TL::kThreads == 0, "whole stores");
#pragma unroll
    for (int j = 0; j < TL::BM * kPerRow / TL::kThreads; ++j) {
        const int i = tid + j * TL::kThreads;
        const int r = i / kPerRow;
        const int cc = (i % kPerRow) * 4;
        const int row = col_a + r;
        const int col = col_b + cc;
        if (row < c && col < c)
            *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * c +
                                       col) =
                *reinterpret_cast<const float4*>(c_s + r * kOut + cc);
    }
}

// The second pass, for i <= j: out[l][i][j] = out[l][j][i] = scale * sum
// of part[l][k][i][j] over the splits k. A block covers 32 columns and
// kRows rows, with G (1, 2, 4 or 8) groups of consecutive splits: each
// thread sums its rows (4 rows for one group, else 1) over its group's
// splits in increasing order, then the groups' sums are added in
// increasing order. The block's values are staged in shared memory and
// the mirror (j, i) is written as rows of kRows consecutive values.
// Blocks wholly below the diagonal return.
template <int G>
struct Reduce {
    static constexpr int kStep = 8 / G;  // rows apart of a thread's rows
    static constexpr int kQ = G == 1 ? 4 : 1;  // rows of a thread
    static constexpr int kRows = kQ * kStep;
};

template <int G>
__global__ void __launch_bounds__(256)
gram_reduce_kernel(const float* __restrict__ part, int splits, int c,
                   float scale, float* __restrict__ out) {
    using R = Reduce<G>;
    const int i0 = blockIdx.y * R::kRows;
    const int j0 = blockIdx.x * 32;
    if (j0 + 31 < i0) return;
    const int tx = threadIdx.x;
    const int r = threadIdx.y / G;
    const int g = threadIdx.y % G;
    const int j = j0 + tx;
    const size_t cc = static_cast<size_t>(c) * c;
    part += static_cast<size_t>(blockIdx.z) * splits * cc;
    out += static_cast<size_t>(blockIdx.z) * cc;

    const int per = (splits + G - 1) / G;
    const int k0 = g * per;
    const int k1 = min(splits, k0 + per);
    bool ok[R::kQ];
    float s[R::kQ];
    const float* p[R::kQ];
#pragma unroll
    for (int q = 0; q < R::kQ; ++q) {
        const int i = i0 + r + q * R::kStep;
        ok[q] = i < c && j < c && i <= j;
        s[q] = 0.f;
        p[q] = part + static_cast<size_t>(k0) * cc +
               static_cast<size_t>(i) * c + j;
    }
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
#pragma unroll
        for (int q = 0; q < R::kQ; ++q) {
            if (ok[q]) s[q] += *p[q];
            p[q] += cc;
        }
    }
    __shared__ float sums[R::kQ][8][32];
    __shared__ float vals[R::kRows][33];
#pragma unroll
    for (int q = 0; q < R::kQ; ++q) sums[q][threadIdx.y][tx] = s[q];
    __syncthreads();
    if (g == 0) {
#pragma unroll
        for (int q = 0; q < R::kQ; ++q) {
            if (!ok[q]) continue;
            float v = sums[q][r * G][tx];
#pragma unroll
            for (int h = 1; h < G; ++h) v += sums[q][r * G + h][tx];
            v *= scale;
            const int rr = r + q * R::kStep;
            vals[rr][tx] = v;
            out[static_cast<size_t>(i0 + rr) * c + j] = v;
        }
    }
    __syncthreads();
#pragma unroll
    for (int t = threadIdx.y * 32 + tx; t < 32 * R::kRows; t += 256) {
        const int jm = j0 + t / R::kRows;  // mirror row
        const int im = i0 + t % R::kRows;  // mirror column
        if (jm < c && im < jm)
            out[static_cast<size_t>(jm) * c + im] =
                vals[t % R::kRows][t / R::kRows];
    }
}

template <class TL, typename T>
int launch_partial(const void* f, int batch, int n, int c, int splits,
                   int rows_per_split, float* part, cudaStream_t stream) {
    constexpr int bytes = TL::template smem_bytes<T>();
    const cudaError_t err = cudaFuncSetAttribute(
        gram_partial_kernel<TL, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_tiles = (c + TL::BM - 1) / TL::BM;
    const dim3 grid(n_tiles * (n_tiles + 1) / 2, splits, batch);
    gram_partial_kernel<TL, T><<<grid, TL::kThreads, bytes, stream>>>(
        static_cast<const T*>(f), n, c, n_tiles, rows_per_split, part);
    return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_reduce_g(int batch, int c, int splits, const float* part,
                    float scale, float* out, cudaStream_t stream) {
    constexpr int rows = Reduce<G>::kRows;
    const dim3 grid((c + 31) / 32, (c + rows - 1) / rows, batch);
    gram_reduce_kernel<G><<<grid, dim3(32, 8), 0, stream>>>(part, splits, c,
                                                           scale, out);
    return static_cast<int>(cudaGetLastError());
}

// groups of splits: 8 or fewer splits per thread (up to 8 groups)
int launch_reduce(int batch, int c, int splits, const float* part,
                  float scale, float* out, cudaStream_t stream) {
    if (splits <= 8)
        return launch_reduce_g<1>(batch, c, splits, part, scale, out, stream);
    if (splits <= 16)
        return launch_reduce_g<2>(batch, c, splits, part, scale, out, stream);
    if (splits <= 32)
        return launch_reduce_g<4>(batch, c, splits, part, scale, out, stream);
    return launch_reduce_g<8>(batch, c, splits, part, scale, out, stream);
}

// 64 x 64 tiles of 4 warps of 32 x 32, a 4-stage ring of 32-row chunks
using GramTile = Tile<2, 2, 2, 4, 32, 4>;

template <typename T>
int launch(const void* f, int batch, int n, int c, int splits,
           int rows_per_split, float scale, float* part, float* out,
           cudaStream_t stream) {
    if (batch < 1 || batch > 65535 || n < 1 || c < 8 || c % 8 != 0 ||
        splits < 1 || splits > 65535 || rows_per_split < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int err = launch_partial<GramTile, T>(f, batch, n, c, splits,
                                                rows_per_split, part, stream);
    if (err != 0) return err;
    return launch_reduce(batch, c, splits, part, scale, out, stream);
}

}  // namespace

extern "C" {

// f: (batch, n, c) row-major, 16-byte aligned, c % 8 == 0; dtype 0 =
// float32, 1 = bfloat16. part: (batch, splits, c, c) float32 workspace;
// out: (batch, c, c) float32. Returns the cudaError_t of the launches
// (0 = success).
int astt_gram(const void* f, int dtype, int batch, int n, int c, int splits,
              int rows_per_split, float scale, float* part, float* out,
              void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch<float>(f, batch, n, c, splits, rows_per_split, scale,
                             part, out, s);
    if (dtype == 1)
        return launch<__nv_bfloat16>(f, batch, n, c, splits, rows_per_split,
                                     scale, part, out, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
