// Total-variation sums for Hopper (sm_90a), one pair per image.
//
// Replaces the TPU kernel artstyletransfer_tpu/ops/pallas_kernels.py
// `_tv_kernel` (driven by `_tv_means` / `tv_pallas`, vmapped over the
// lanes of a batch). Over the (h, w*c) view of each NHWC float32 image b of
// a batch (a lane):
//   sx[b] = sum |y[b, i, j] - y[b, i, j + c]|   (horizontal neighbours)
//   sy[b] = sum |y[b, i, j] - y[b, i + 1, j]|   (vertical neighbours)
// The wrapper turns them into each lane's TV = (sx / (h (w-1) c))^2 +
// (sy / ((h-1) w c))^2.
//
// The TPU kernel holds the whole image in VMEM and so takes only images
// that fit it. Here the grid is (blocks per lane) x (lanes): a grid-stride
// pass over each lane's image reads each element once (its right and lower
// neighbours come from L1/L2), keeps two float32 partial sums per thread,
// reduces them per block with warp shuffles, and writes one pair per
// block. A second kernel, one block per lane, sums the lane's pairs in a
// fixed order in double: deterministic, no atomics, any image size, one
// launch pair for every lane.
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

// grid (nblocks, batch): block x of lane y strides over that lane's image
__global__ void __launch_bounds__(kThreads)
tv_partial_kernel(const float* __restrict__ y, int64_t per_lane, int wc, int c,
                  float* __restrict__ partial) {
    const int64_t lane = blockIdx.y;
    y += lane * per_lane;
    float sx = 0.f, sy = 0.f;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    const int64_t last_row = per_lane - wc;  // first element of the last row
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         idx < per_lane; idx += stride) {
        const int j = static_cast<int>(idx % wc);
        const float v = y[idx];
        if (j < wc - c) sx += fabsf(v - y[idx + c]);
        if (idx < last_row) sy += fabsf(v - y[idx + wc]);
    }
    __shared__ float red[2][kThreads / 32];
    sx = warp_sum(sx);
    sy = warp_sum(sy);
    const int lane_id = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    if (lane_id == 0) {
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
        const int64_t k = lane * gridDim.x + blockIdx.x;
        partial[2 * k] = bx;
        partial[2 * k + 1] = by;
    }
}

// out[2b] = sum of lane b's partial sx, out[2b+1] of its sy; one block per
// lane, each thread a fixed stride of blocks, then a fixed-order tree
__global__ void __launch_bounds__(kThreads)
tv_final_kernel(const float* __restrict__ partial, int nblocks,
                float* __restrict__ out) {
    const int64_t lane = blockIdx.x;
    partial += 2 * lane * nblocks;
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
        out[2 * lane] = static_cast<float>(red[0][0]);
        out[2 * lane + 1] = static_cast<float>(red[1][0]);
    }
}

}  // namespace

extern "C" {

// y: (b, h, w, c) float32 contiguous; partial: (b, nblocks, 2) float32
// workspace; out: (b, 2) float32 = each lane's (sx, sy).
// Returns the cudaError_t of the launches (0 = success).
int astt_tv_sums(const float* y, int b, int h, int w, int c, int nblocks,
                 float* partial, float* out, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int wc = w * c;
    const int64_t per_lane = static_cast<int64_t>(h) * wc;
    tv_partial_kernel<<<dim3(nblocks, b), kThreads, 0, s>>>(y, per_lane, wc, c,
                                                            partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    tv_final_kernel<<<b, kThreads, 0, s>>>(partial, nblocks, out);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
