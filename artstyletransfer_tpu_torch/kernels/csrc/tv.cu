// Total-variation sums for Hopper (sm_90a).
//
// Replaces the TPU kernel artstyletransfer_tpu/ops/pallas_kernels.py
// `_tv_kernel` (driven by `_tv_means` / `tv_pallas`). Over the (h, w*c)
// view of each NHWC float32 image of a batch:
//   sx = sum |y[i, j] - y[i, j + c]|   (horizontal neighbours)
//   sy = sum |y[i, j] - y[i + 1, j]|   (vertical neighbours, same image)
// The wrapper turns them into TV = (sx / (b h (w-1) c))^2 +
// (sy / (b (h-1) w c))^2.
//
// The TPU kernel holds the whole image in VMEM and so takes only images
// that fit it. Here a grid-stride pass reads each element once (its right
// and lower neighbours come from L1/L2), keeps two float32 partial sums per
// thread, reduces them per block with warp shuffles, and writes one pair
// per block. A second one-block kernel sums the pairs in a fixed order in
// double: deterministic, no atomics, any image size.
//
// Bound on the H100: 4 bytes per element read once over 3.35 TB/s —
// memory-bound (a few FLOPs per element).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

__global__ void __launch_bounds__(kThreads)
tv_partial_kernel(const float* __restrict__ y, int64_t total, int h, int wc,
                  int c, float* __restrict__ partial) {
    float sx = 0.f, sy = 0.f;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         idx < total; idx += stride) {
        const int j = static_cast<int>(idx % wc);
        const int64_t row = idx / wc;
        const int i = static_cast<int>(row % h);
        const float v = y[idx];
        if (j < wc - c) sx += fabsf(v - y[idx + c]);
        if (i < h - 1) sy += fabsf(v - y[idx + wc]);
    }
    __shared__ float red[2][kThreads / 32];
    sx = warp_sum(sx);
    sy = warp_sum(sy);
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    if (lane == 0) {
        red[0][warp] = sx;
        red[1][warp] = sy;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float bx = 0.f, by = 0.f;
        for (int w = 0; w < kThreads / 32; ++w) {
            bx += red[0][w];
            by += red[1][w];
        }
        partial[2 * blockIdx.x] = bx;
        partial[2 * blockIdx.x + 1] = by;
    }
}

// out[0] = sum of partial[2k], out[1] = sum of partial[2k+1]; one block,
// each thread a fixed stride of blocks, then a fixed-order tree
__global__ void __launch_bounds__(kThreads)
tv_final_kernel(const float* __restrict__ partial, int nblocks,
                float* __restrict__ out) {
    __shared__ double red[2][kThreads];
    double sx = 0.0, sy = 0.0;
    for (int k = threadIdx.x; k < nblocks; k += kThreads) {
        sx += partial[2 * k];
        sy += partial[2 * k + 1];
    }
    red[0][threadIdx.x] = sx;
    red[1][threadIdx.x] = sy;
    __syncthreads();
    for (int half = kThreads / 2; half > 0; half >>= 1) {
        if (threadIdx.x < half) {
            red[0][threadIdx.x] += red[0][threadIdx.x + half];
            red[1][threadIdx.x] += red[1][threadIdx.x + half];
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        out[0] = static_cast<float>(red[0][0]);
        out[1] = static_cast<float>(red[1][0]);
    }
}

}  // namespace

extern "C" {

// y: (b, h, w, c) float32 contiguous; partial: (2 * nblocks) float32
// workspace; out: (2,) float32 = (sx, sy).
// Returns the cudaError_t of the launches (0 = success).
int astt_tv_sums(const float* y, int b, int h, int w, int c, int nblocks,
                 float* partial, float* out, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int wc = w * c;
    const int64_t total = static_cast<int64_t>(b) * h * wc;
    tv_partial_kernel<<<nblocks, kThreads, 0, s>>>(y, total, h, wc, c, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    tv_final_kernel<<<1, kThreads, 0, s>>>(partial, nblocks, out);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
