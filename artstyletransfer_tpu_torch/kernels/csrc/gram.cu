// Gram forward for Hopper (sm_90a): G = s * F^T F.
//
// Replaces the TPU kernel artstyletransfer_tpu/ops/pallas_kernels.py
// `_gram_kernel` (driven by `_gram_fwd_impl`, which vmaps it over the
// batch). F is a (B, n, c) row-major stack of feature matrices, one per
// lane (an NHWC tap, n = h*w), float32 or bfloat16; G is (B, c, c)
// float32. One launch serves every lane: the lane is blockIdx.z.
//
// The TPU kernel walks the rows in a sequential grid and carries the sum in
// VMEM. Blocks here run in parallel, so the sum is split over rows
// (split-K): the grid is (upper-triangular 64x64 output tiles) x (row
// splits) x (lanes). Each block streams its row range through shared
// memory in 32-row stages, accumulates a 64x64 tile in float32 registers
// (4x4 per thread) and writes it, and its mirror, into its own (c, c) slice
// of a (B, splits, c, c) workspace. A second kernel sums each lane's slices
// in a fixed order and scales by s: deterministic, no atomics. G is
// symmetric, so only tiles with ti <= tj are computed.
//
// Bound on the H100, per lane: n*c*(c+1) FLOPs, the upper triangle only
// (67 TFLOP/s f32), vs n*c*elem bytes (3.35 TB/s). In float32 the c = 64 shapes are
// bytes-bound and c >= 128 FLOP-bound; wgmma on bf16/TF32 tiles is the
// later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 64;
constexpr int kStage = 32;
constexpr int kThreads = 256;  // 16 x 16, 4 x 4 outputs each

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const T* __restrict__ f, int n, int c, int n_tiles,
                    int rows_per_split, float* __restrict__ part) {
    __shared__ float a_s[kStage][kTile];
    __shared__ float b_s[kStage][kTile];

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
    const int col_a = ti * kTile;
    const int col_b = tj * kTile;

    const int split = blockIdx.y;
    const size_t lane = blockIdx.z;
    f += lane * n * c;
    const int r_begin = split * rows_per_split;
    const int r_end = min(n, r_begin + rows_per_split);

    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int r0 = r_begin; r0 < r_end; r0 += kStage) {
        for (int idx = tid; idx < kStage * kTile; idx += kThreads) {
            const int r = idx / kTile;
            const int col = idx % kTile;
            const int row = r0 + r;
            const bool row_ok = row < r_end;
            const size_t base = static_cast<size_t>(row) * c;
            a_s[r][col] = (row_ok && col_a + col < c)
                              ? load_f32(f + base + col_a + col) : 0.f;
            b_s[r][col] = (row_ok && col_b + col < c)
                              ? load_f32(f + base + col_b + col) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < kStage; ++k) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = a_s[k][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = b_s[k][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

    float* out = part + (lane * gridDim.y + split) * c * c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int gi = col_a + ty + 16 * i;
        if (gi >= c) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int gj = col_b + tx + 16 * j;
            if (gj >= c) continue;
            out[static_cast<size_t>(gi) * c + gj] = acc[i][j];
            if (ti != tj) out[static_cast<size_t>(gj) * c + gi] = acc[i][j];
        }
    }
}

// out[l][i] = scale * sum_k part[l][k][i], k in increasing order
__global__ void gram_reduce_kernel(const float* __restrict__ part, int splits,
                                   int cc, int64_t total, float scale,
                                   float* __restrict__ out) {
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
        const int64_t lane = idx / cc;
        const int64_t i = idx % cc;
        const float* p = part + lane * splits * cc + i;
        float s = 0.f;
        for (int k = 0; k < splits; ++k) s += p[static_cast<int64_t>(k) * cc];
        out[idx] = s * scale;
    }
}

template <typename T>
int launch(const void* f, int batch, int n, int c, int splits,
           int rows_per_split, float scale, float* part, float* out,
           cudaStream_t stream) {
    const int n_tiles = (c + kTile - 1) / kTile;
    const dim3 grid(n_tiles * (n_tiles + 1) / 2, splits, batch);
    gram_partial_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(f), n, c, n_tiles, rows_per_split, part);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int cc = c * c;
    const int64_t total = static_cast<int64_t>(batch) * cc;
    const int blocks = static_cast<int>(std::min<int64_t>((total + 255) / 256, 1024));
    gram_reduce_kernel<<<blocks, 256, 0, stream>>>(part, splits, cc, total,
                                                   scale, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// f: (batch, n, c) row-major; dtype 0 = float32, 1 = bfloat16.
// part: (batch, splits, c, c) float32 workspace; out: (batch, c, c) float32.
// Returns the cudaError_t of the launches (0 = success).
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
