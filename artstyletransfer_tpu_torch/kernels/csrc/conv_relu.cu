// Fused SAME 3x3 stride-1 convolution + bias + ReLU for Hopper (sm_90a),
// NHWC input, HWIO weights, float32:
//   y[n, h, w, o] = max(0, b[o] + sum_{dy, dx, i} x[n, h+dy-1, w+dx-1, i]
//                                                 * wt[dy, dx, i, o])
// with zeros outside the image (NaN propagates, as in max(y, 0) of the
// framework).
//
// Replaces the TPU kernel artstyletransfer_tpu/ops/pallas_kernels.py:267
// `_conv_relu_kernel` (driven by `_conv_relu_fwd_impl` :304 and
// `conv3x3_relu_pallas` :333), which DMAs a (tile_h+2)-row halo slab of an
// input padded in HBM into VMEM and runs nine shifted MXU matmuls on it.
// Here nothing is padded in device memory, and any batch, image size, Cin
// and Cout run.
//
// Bounds on the H100, P = N*H*W output pixels: 2*P*9*Cin*Cout operations
// over 67 TFLOP/s on the f32 CUDA cores, or 3x that over 495 TFLOP/s for
// 3xTF32 on the tensor cores (float32 work at 165 TFLOP/s); the bytes,
// (P*(Cin+Cout) + 9*Cin*Cout)*4 over 3.35 TB/s, bind at no VGG19 shape.
//
// Two kernels, chosen by the wrapper (kernels/conv_relu.py):
//
// conv3x3_relu_tc_kernel: an implicit GEMM on the tensor cores, for Cin and
// Cout multiples of 4 (16-byte copies) and 16-byte aligned x and wt.
//   out(P, Cout) = sum over the 9 taps of shift_tap(x)(P, Cin) . wt_tap
// - Tiles: a block computes 8 x 16 output pixels x 64 output channels with
//   4 warps of 4 rows x 16 pixels x 32 channels (4 x 4 MMA tiles of
//   16 x 8), walking Cin in chunks of BK channels.
// - Operands: per chunk, a ring of 16-byte cp.async.cg copies stages the
//   (8+2) x (16+2) x BK halo slab once, the halo's zeros and the ragged
//   channel edge made by the copy itself (src-size 0), and the matching
//   9 x BK x 64 weight slice. All nine taps read their A fragments from
//   that one slab at shifted offsets: the TPU kernel's nine shifted
//   matmuls on one slab, in shared memory. A warp splits each slab row's
//   fragment once per (dx, k-step) and uses it for the three dy taps that
//   read it (6 row fragments for 12 tap-row products). Channel strides are
//   padded (BK + 4, 64 + 8 floats) so every fragment read hits 32 banks.
// - 3xTF32, as in gram_bwd.cu: each float32 operand x = hi + lo, hi rounded
//   to nearest TF32 by two integer operations, lo = x - hi read truncated by
//   the tensor core; a_lo*b_hi + a_hi*b_lo + a_hi*b_hi by mma.sync m16n8k8.
//   As in gram.cu, each chunk's products (9 * BK per output) are summed from
//   zero and added to the block's float32 sum by FADD: the tensor core's
//   accumulation does not round to nearest, and over K = 9 * 512 its error
//   would grow past float32's.
// - Split over input channels where the pixel tiles x channel blocks x
//   images are under a wave of the card (16^2 and 32^2 images at 512
//   channels: 16-64 blocks on 132 SMs). Each split writes raw sums into
//   its slice of a (splits, N, H, W, Cout) workspace, and
//   conv_split_sum_kernel adds the slices in a fixed order, then the bias
//   and the ReLU. Without a split the first pass does that epilogue itself.
//   No atomics: two calls give the same bits.
// - mma.sync issues every MMA, fragment load and split from the warp's own
//   instruction stream (about a third of the TF32 peak in the Gram
//   kernels). wgmma fed by TMA (im2col tensor maps) is the later step.
//
// conv3x3_relu_kernel: the CUDA-core kernel, for Cin = 3 (VGG19's conv1_1,
// where 9 * 3 products per output leave the tensor cores nothing to do)
// and for channel counts or pointers that break 16-byte copies. 8 x 16
// pixels x 64 output channels per block, Cin in chunks of 8 staged with
// their halo (24 KB), 8 x 8 float32 FMA accumulators per thread.
//
// Offsets within one image are 32-bit: the wrapper refuses tensors of 2^31
// elements or more.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// The tensor-core implicit GEMM
// ---------------------------------------------------------------------------

// A block: 8 x 16 output pixels x 64 output channels, 2 x 2 warps of 4
// rows x 32 channels; Cin walked in BK-channel chunks through a ring of
// STAGES buffers, each a halo slab and a weight slice.
template <int BK_, int STAGES_, int MIN_BLOCKS_>
struct TcTile {
    static constexpr int TH = 8, TW = 16, BN = 64;
    static constexpr int BK = BK_;
    static constexpr int kStages = STAGES_;
    static constexpr int kMinBlocks = MIN_BLOCKS_;
    static constexpr int kThreads = 128;
    static constexpr int SH = TH + 2, SW = TW + 2;  // halo slab
    static constexpr int KS = BK + 4;  // slab channel stride: 4 (mod 8) words
    static constexpr int NS = BN + 8;  // weight row stride: 8 (mod 32) words
    static constexpr int kSlab = SH * SW * KS;
    static constexpr int kWts = 9 * BK * NS;
    static constexpr int kStage = kSlab + kWts;
    static constexpr int kSmemBytes = kStages * kStage * 4;
    static_assert(BK % 8 == 0, "whole MMA k-steps");
};

// x = hi + lo: hi is x rounded to TF32, to nearest with ties away from zero
// (cvt.rna's rounding as two integer operations); lo = x - hi is exact in
// float32, and the tensor core reads its top 10 mantissa bits.
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

// One chunk, input channels [c0, c0 + BK): the halo slab of the block's
// pixels ([row][col][channel], zeros outside the image and past cin) and
// the weight slice ([tap][channel][output], zeros past cin and cout).
// cin % 4 == 0 and cout % 4 == 0: no 16-byte copy straddles an edge. A
// thread's copies are one base address plus offsets known at compile time
// (its 16-byte piece of a pixel or a weight row is the same in every pass).
template <class TL>
__device__ __forceinline__ void load_chunk(float* slab, float* wts,
                                           const float* xi, const float* wt,
                                           int height, int width, int cin,
                                           int cout, int h0, int w0, int o0,
                                           int c0, int tid) {
    constexpr int kQ = TL::BK / 4;             // pieces of a pixel's chunk
    constexpr int kPix = TL::kThreads / kQ;    // pixels per pass
    constexpr int kPixels = TL::SH * TL::SW;
    const int ci = c0 + 4 * (tid % kQ);
    const float* x_src = xi + ci;
    float* x_dst = slab + 4 * (tid % kQ);
#pragma unroll
    for (int j = 0; j < (kPixels + kPix - 1) / kPix; ++j) {
        const int p = tid / kQ + j * kPix;
        if (kPixels % kPix == 0 || p < kPixels) {
            const int gy = h0 + p / TL::SW - 1;
            const int gx = w0 + p % TL::SW - 1;
            const bool ok = gy >= 0 && gy < height && gx >= 0 &&
                            gx < width && ci < cin;
            cp_async16(x_dst + p * TL::KS,
                       ok ? x_src + (gy * width + gx) * cin : xi,
                       ok ? 16 : 0);
        }
    }
    constexpr int kR = TL::BN / 4;             // pieces of a weight row
    constexpr int kRows = TL::kThreads / kR;   // rows per pass
    static_assert(TL::BK % kRows == 0, "a pass stays within one tap");
    const int r0 = tid / kR;
    const int o = o0 + 4 * (tid % kR);
    const float* w_src = wt + (c0 + r0) * cout + o;  // tap 0
    float* w_dst = wts + r0 * TL::NS + 4 * (tid % kR);
#pragma unroll
    for (int j = 0; j < 9 * TL::BK / kRows; ++j) {
        const int tap = j * kRows / TL::BK;
        const int kk = j * kRows % TL::BK;  // the channel is c0 + r0 + kk
        const bool ok = c0 + r0 + kk < cin && o < cout;
        cp_async16(w_dst + j * kRows * TL::NS,
                   ok ? w_src + (tap * cin + kk) * cout : wt, ok ? 16 : 0);
    }
}

// The warp's MMAs over one staged chunk, into part. Output row 4 * wr + i
// (i < 4) reads slab row 4 * wr + i + dy at tap (dy, dx). Per (dx, k-step)
// the warp splits each of its 6 slab rows once: the 4 rows that tap dy
// reads form a window that slides by one row from dy to dy + 1, so 4 rows
// of fragments are live at a time. A fragment: pixels (columns) g, g+8 x
// channels t, t+4; B fragment: channels t, t+4 x outputs g.
template <class TL>
__device__ __forceinline__ void mma_chunk(float (&part)[4][4][4],
                                          const float* slab, const float* wts,
                                          int wr, int wc, int gq, int tq) {
    constexpr int KS = TL::KS, NS = TL::NS;
#pragma unroll 1
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
        for (int kk = 0; kk < TL::BK; kk += 8) {
            const float* a_s =
                slab + (4 * wr * TL::SW + dx + gq) * KS + kk + tq;
            uint32_t a_hi[6][4], a_lo[6][4];
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
                for (int r = dy == 0 ? 0 : dy + 3; r < dy + 4; ++r) {
                    const float* p = a_s + r * TL::SW * KS;
                    const float x[4] = {p[0], p[8 * KS], p[4], p[8 * KS + 4]};
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        split(x[e], a_hi[r][e], a_lo[r][e]);
                }
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float* p =
                        wts + ((dy * 3 + dx) * TL::BK + kk + tq) * NS +
                        32 * wc + 8 * j + gq;
                    uint32_t b_hi[2], b_lo[2];
                    split(p[0], b_hi[0], b_lo[0]);
                    split(p[4 * NS], b_hi[1], b_lo[1]);
                    // small products first, the large one last
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        mma(part[i][j], a_lo[i + dy], b_hi);
                        mma(part[i][j], a_hi[i + dy], b_lo);
                        mma(part[i][j], a_hi[i + dy], b_hi);
                    }
                }
            }
        }
    }
}

// grid: (pixel tiles x output-channel blocks, splits, images). Split s
// walks chunks [s * chunks_per_split, ...) of the ceil(cin / BK). With one
// split the block writes max(sum + bias, 0) to y, else its raw sums to
// part[s].
template <class TL>
__global__ void __launch_bounds__(TL::kThreads, TL::kMinBlocks)
conv3x3_relu_tc_kernel(const float* __restrict__ x,
                       const float* __restrict__ wt,
                       const float* __restrict__ bias, int height, int width,
                       int cin, int cout, int tiles_w, int chunks_per_split,
                       float* __restrict__ part, float* __restrict__ y) {
    extern __shared__ __align__(16) float smem[];
    const int o_blocks = (cout + TL::BN - 1) / TL::BN;
    const int tile = blockIdx.x / o_blocks;  // a tile's channel blocks are
    const int o0 = (blockIdx.x % o_blocks) * TL::BN;  // neighbours: L2 reuse
    const int h0 = (tile / tiles_w) * TL::TH;
    const int w0 = (tile % tiles_w) * TL::TW;
    const int img = blockIdx.z;
    const float* xi = x + static_cast<size_t>(img) * height * width * cin;

    const int chunks = (cin + TL::BK - 1) / TL::BK;
    const int k_begin = blockIdx.y * chunks_per_split;
    const int k_count = min(chunks, k_begin + chunks_per_split) - k_begin;

    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int wr = warp / 2;    // output rows 4 wr .. 4 wr + 3
    const int wc = warp % 2;    // output channels 32 wc .. 32 wc + 31
    const int gq = (tid % 32) / 4;  // MMA fragment group
    const int tq = tid % 4;         // thread in group

    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
    for (int s = 0; s < TL::kStages - 1; ++s) {
        if (s < k_count)
            load_chunk<TL>(smem + s * TL::kStage,
                           smem + s * TL::kStage + TL::kSlab, xi, wt, height,
                           width, cin, cout, h0, w0, o0,
                           (k_begin + s) * TL::BK, tid);
        cp_async_commit();
    }
    for (int kt = 0; kt < k_count; ++kt) {
        cp_async_wait<TL::kStages - 2>();  // chunk kt has landed (this thread)
        __syncthreads();                   // ... for all; chunk kt-1 consumed
        const int next = kt + TL::kStages - 1;
        if (next < k_count) {
            float* st = smem + (next % TL::kStages) * TL::kStage;
            load_chunk<TL>(st, st + TL::kSlab, xi, wt, height, width, cin,
                           cout, h0, w0, o0, (k_begin + next) * TL::BK, tid);
        }
        cp_async_commit();

        // the chunk's sum starts from zero and is added to acc in float32
        float part_acc[4][4][4] = {};
        const float* st = smem + (kt % TL::kStages) * TL::kStage;
        mma_chunk<TL>(part_acc, st, st + TL::kSlab, wr, wc, gq, tq);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int r = 0; r < 4; ++r) acc[i][j][r] += part_acc[i][j][r];
    }
    cp_async_wait<0>();

    // C fragments: (pixel g, outputs 2t, 2t+1) and (pixel g+8, 2t, 2t+1);
    // a warp's float2 stores fill whole 32-byte sectors (8 outputs of 8
    // pixels)
    const bool fused = gridDim.y == 1;
    float* out = fused ? y
                       : part + static_cast<size_t>(blockIdx.y) * gridDim.z *
                                    height * width * cout;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int oh = h0 + 4 * wr + i;
        if (oh >= height) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int ow = w0 + gq + 8 * half;
            if (ow >= width) continue;
            float* row = out + (static_cast<size_t>(img) * height * width +
                                oh * width + ow) * cout;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int o = o0 + 32 * wc + 8 * j + 2 * tq;
                if (o >= cout) continue;  // cout % 4 == 0: o + 1 < cout too
                float v0 = acc[i][j][2 * half], v1 = acc[i][j][2 * half + 1];
                if (fused) {
                    v0 += bias[o];
                    v1 += bias[o + 1];
                    v0 = v0 < 0.f ? 0.f : v0;
                    v1 = v1 < 0.f ? 0.f : v1;
                }
                *reinterpret_cast<float2*>(row + o) = make_float2(v0, v1);
            }
        }
    }
}

// The second pass of a split: y = max(sum over s of part[s] + bias, 0),
// the splits added in increasing order, 4 outputs per thread.
__global__ void __launch_bounds__(256)
conv_split_sum_kernel(const float4* __restrict__ part,
                      const float* __restrict__ bias, int splits,
                      size_t total4, int cout, float4* __restrict__ y) {
    const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
    for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < total4; i += stride) {
        float4 s = part[i];
        for (int k = 1; k < splits; ++k) {
            const float4 v = part[k * total4 + i];
            s.x += v.x;
            s.y += v.y;
            s.z += v.z;
            s.w += v.w;
        }
        const int o = static_cast<int>((4 * i) % cout);
        float r[4] = {s.x + bias[o], s.y + bias[o + 1], s.z + bias[o + 2],
                      s.w + bias[o + 3]};
#pragma unroll
        for (int e = 0; e < 4; ++e) r[e] = r[e] < 0.f ? 0.f : r[e];
        y[i] = make_float4(r[0], r[1], r[2], r[3]);
    }
}

template <class TL>
int launch_tc(const float* x, const float* wt, const float* bias, int n,
              int h, int w, int cin, int cout, int splits,
              int chunks_per_split, float* part, float* y,
              cudaStream_t stream) {
    const int chunks = (cin + TL::BK - 1) / TL::BK;
    if (n < 1 || n > 65535 || h < 1 || w < 1 || cin < 4 || cin % 4 ||
        cout < 4 || cout % 4 || splits < 1 || splits > 65535 ||
        chunks_per_split < 1 || (splits - 1) * chunks_per_split >= chunks ||
        splits * chunks_per_split < chunks || (splits > 1 && part == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_relu_tc_kernel<TL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, TL::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles_w = (w + TL::TW - 1) / TL::TW;
    const int tiles_h = (h + TL::TH - 1) / TL::TH;
    const int o_blocks = (cout + TL::BN - 1) / TL::BN;
    const dim3 grid(tiles_h * tiles_w * o_blocks, splits, n);
    conv3x3_relu_tc_kernel<TL><<<grid, TL::kThreads, TL::kSmemBytes, stream>>>(
        x, wt, bias, h, w, cin, cout, tiles_w, chunks_per_split, part, y);
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
    const size_t total4 = static_cast<size_t>(n) * h * w * cout / 4;
    const size_t blocks = (total4 + 255) / 256;
    const unsigned sum_blocks =
        static_cast<unsigned>(blocks < 8192 ? blocks : 8192);
    conv_split_sum_kernel<<<sum_blocks, 256, 0, stream>>>(
        reinterpret_cast<const float4*>(part), bias, splits, total4, cout,
        reinterpret_cast<float4*>(y));
    return static_cast<int>(cudaGetLastError());
}

// 16-channel chunks, 2 stages of 55.9 KB: two blocks per SM
using ConvTile = TcTile<16, 2, 2>;

// ---------------------------------------------------------------------------
// The CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kTileH = 8;    // output rows per block
constexpr int kTileW = 16;   // output columns per block
constexpr int kTileO = 64;   // output channels per block
constexpr int kChunk = 8;    // input channels per shared-memory stage
constexpr int kThreads = 128;
constexpr int kSlabH = kTileH + 2;
constexpr int kSlabW = kTileW + 2;
constexpr int kSlab = kSlabH * kSlabW * kChunk;  // 1440 floats
constexpr int kWts = 9 * kChunk * kTileO;        // 4608 floats

__global__ void __launch_bounds__(kThreads)
conv3x3_relu_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                    const float* __restrict__ bias, int height, int width,
                    int cin, int cout, int tiles_w, float* __restrict__ y) {
    __shared__ float in_s[kSlab];   // [row][col][k]
    __shared__ float w_s[kWts];     // [tap][k][o]

    const int tile = blockIdx.x;
    const int h0 = (tile / tiles_w) * kTileH;
    const int w0 = (tile % tiles_w) * kTileW;
    const int o0 = blockIdx.y * kTileO;
    const int img = blockIdx.z;
    const float* xi = x + img * height * width * cin;

    const int tid = threadIdx.x;
    const int tx = tid % 8;   // output channels tx + 8j
    const int ty = tid / 8;   // tile column; rows 0..7

    float acc[kTileH][8];
#pragma unroll
    for (int i = 0; i < kTileH; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < cin; c0 += kChunk) {
        for (int idx = tid; idx < kSlab; idx += kThreads) {
            const int k = idx % kChunk;
            const int p = idx / kChunk;
            const int gy = h0 + p / kSlabW - 1;
            const int gx = w0 + p % kSlabW - 1;
            const int ci = c0 + k;
            const bool ok = gy >= 0 && gy < height && gx >= 0 && gx < width
                            && ci < cin;
            in_s[idx] = ok ? xi[(gy * width + gx) * cin + ci] : 0.f;
        }
        for (int idx = tid; idx < kWts; idx += kThreads) {
            const int o = idx % kTileO;
            const int k = (idx / kTileO) % kChunk;
            const int tap = idx / (kTileO * kChunk);
            const int ci = c0 + k;
            const int go = o0 + o;
            w_s[idx] = (ci < cin && go < cout)
                           ? wt[(tap * cin + ci) * cout + go] : 0.f;
        }
        __syncthreads();
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
            const int dy = tap / 3;
            const int dx = tap % 3;
            const float* in_t = in_s + (dy * kSlabW + ty + dx) * kChunk;
            const float* w_t = w_s + tap * kChunk * kTileO + tx;
#pragma unroll
            for (int k = 0; k < kChunk; ++k) {
                float a[kTileH], b[8];
#pragma unroll
                for (int i = 0; i < kTileH; ++i) a[i] = in_t[i * kSlabW * kChunk + k];
#pragma unroll
                for (int j = 0; j < 8; ++j) b[j] = w_t[k * kTileO + 8 * j];
#pragma unroll
                for (int i = 0; i < kTileH; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
            }
        }
        __syncthreads();
    }

    const int ow = w0 + ty;
    if (ow >= width) return;
    float* yi = y + img * height * width * cout;
#pragma unroll
    for (int i = 0; i < kTileH; ++i) {
        const int oh = h0 + i;
        if (oh >= height) continue;
        float* row = yi + (oh * width + ow) * cout;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int o = o0 + tx + 8 * j;
            if (o >= cout) continue;
            const float v = acc[i][j] + bias[o];
            row[o] = v < 0.f ? 0.f : v;
        }
    }
}

}  // namespace

extern "C" {

// x: (n, h, w, cin) float32 NHWC contiguous; wt: (3, 3, cin, cout) HWIO
// contiguous; bias: (cout,); y: (n, h, w, cout) float32. n <= 65535.
// Returns the cudaError_t of the launch (0 = success).
int astt_conv3x3_relu(const float* x, const float* wt, const float* bias,
                      int n, int h, int w, int cin, int cout, float* y,
                      void* stream) {
    const int tiles_w = (w + kTileW - 1) / kTileW;
    const int tiles_h = (h + kTileH - 1) / kTileH;
    const dim3 grid(tiles_h * tiles_w, (cout + kTileO - 1) / kTileO, n);
    conv3x3_relu_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, wt, bias, h, w, cin, cout, tiles_w, y);
    return static_cast<int>(cudaGetLastError());
}

// The tensor-core kernel: cin and cout multiples of 4, x and wt 16-byte
// aligned; splits x chunks_per_split cover the ceil(cin / 16) channel
// chunks, every split non-empty; part: (splits, n, h, w, cout) float32
// workspace (unused, may be null, for one split).
int astt_conv3x3_relu_tc(const float* x, const float* wt, const float* bias,
                         int n, int h, int w, int cin, int cout, int splits,
                         int chunks_per_split, float* part, float* y,
                         void* stream) {
    return launch_tc<ConvTile>(x, wt, bias, n, h, w, cin, cout, splits,
                               chunks_per_split, part, y,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
