// Fused SAME 3x3 stride-1 convolution + bias + ReLU for Hopper (sm_90a),
// NHWC input, HWIO weights, float32.
//
// Replaces the TPU kernel artstyletransfer_tpu/ops/pallas_kernels.py:267
// `_conv_relu_kernel` (driven by `_conv_relu_fwd_impl` :293 and
// `conv3x3_relu_pallas` :332):
//   y[n, h, w, o] = max(0, b[o] + sum_{dy, dx, i} x[n, h+dy-1, w+dx-1, i]
//                                                 * wt[dy, dx, i, o])
// with zeros outside the image.
//
// The TPU kernel DMAs a (tile_h+2)-row halo slab of an input that was
// padded in HBM (one pixel of halo, channels to multiples of 128 lanes)
// into VMEM and runs nine shifted MXU matmuls on it. Here nothing is
// padded in device memory: the halo's zeros and a ragged channel count are
// made while loading, so any Cin and Cout and any batch and image size
// run. The grid is (8x16-pixel output tiles) x (64-wide output-channel
// blocks) x (images). Each block loops over the input channels in chunks
// of 8: it stages the (8+2)x(16+2)x8 halo slab and the matching 3x3x8x64
// weight slice in shared memory (24 KB), then each of its 128 threads
// accumulates 8 pixels (a column of the tile) x 8 output channels in
// float32 registers with CUDA-core FMAs: 64 FMAs for every 16 shared-
// memory loads, which a warp reads without bank conflicts (4 distinct
// pixels 8 words apart, 8 consecutive channels). The epilogue adds the bias
// and applies the ReLU (NaN propagates, as in max(y, 0) of the framework).
//
// Bound on the H100: 2*H*W*9*Cin*Cout FLOPs over 67 TFLOP/s (f32, CUDA
// cores) vs (H*W*(Cin+Cout) + 9*Cin*Cout)*4 bytes over 3.35 TB/s: every VGG
// conv is FLOP-bound (512x512, 64->64: 19.3 GFLOP, 0.29 ms). A wgmma/TMA
// implicit GEMM on TF32 or bf16 tiles is the later step.
//
// Offsets are 32-bit: the wrapper refuses tensors of 2^31 elements or more.

#include <cuda_runtime.h>

namespace {

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

}  // extern "C"
