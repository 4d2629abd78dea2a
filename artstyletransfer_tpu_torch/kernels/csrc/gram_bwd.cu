// Gram backward for Hopper (sm_90a): dF = F @ g_sym.
//
// Replaces the TPU kernel artstyletransfer_tpu/ops/pallas_kernels.py
// `_gram_bwd_kernel` (driven by `_gram_bwd_impl` / `_gram_vjp_bwd`, which
// vmap it over the batch). Per lane of a batch: F is the (n, c) row-major
// feature matrix (float32 or bfloat16), g_sym a (c, c) float32 matrix, dF
// (n, c) in F's dtype; the lanes are stacked as (B, n, c), (B, c, c) and
// (B, n, c), and one launch serves them all (blockIdx.z is the lane). The
// one kernel serves both
// backward formulas of the port: the Gram's own VJP, g_sym = s(G_bar +
// G_bar^T), and the fused style-layer loss, g_sym = (D + D^T) 2s/(c^3 h w).
//
// A tiled GEMM: each block owns a 64-row x 64-column tile of dF, walks the
// c-long inner dimension in 32-wide stages through shared memory (F staged
// transposed, padded against bank conflicts) and accumulates in float32
// registers, 4x4 per thread. Rows are independent, so there is no
// cross-block reduction.
//
// Bound on the H100, per lane: 2*n*c^2 FLOPs on CUDA-core FMAs (67 TFLOP/s f32) vs
// 2*n*c*elem + 4*c^2 bytes (3.35 TB/s): in float32, bytes-bound at c = 64,
// FLOP-bound from c = 128 up.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 64;
constexpr int kStage = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_bwd_kernel(const T* __restrict__ f, const float* __restrict__ g, int n,
                int c, T* __restrict__ df) {
    __shared__ float a_s[kStage][kTile + 1];  // F tile, transposed
    __shared__ float b_s[kStage][kTile];      // g_sym tile

    const int row0 = blockIdx.x * kTile;  // x: up to 2^31-1 row tiles
    const int col0 = blockIdx.y * kTile;
    const size_t lane = blockIdx.z;
    f += lane * n * c;
    g += lane * c * c;
    df += lane * n * c;
    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < c; k0 += kStage) {
        for (int idx = tid; idx < kStage * kTile; idx += kThreads) {
            const int m = idx / kStage;
            const int kk = idx % kStage;
            const int row = row0 + m;
            const int k = k0 + kk;
            a_s[kk][m] = (row < n && k < c)
                             ? load_f32(f + static_cast<size_t>(row) * c + k) : 0.f;
        }
        for (int idx = tid; idx < kStage * kTile; idx += kThreads) {
            const int kk = idx / kTile;
            const int nn = idx % kTile;
            const int k = k0 + kk;
            const int col = col0 + nn;
            b_s[kk][nn] = (k < c && col < c)
                              ? g[static_cast<size_t>(k) * c + col] : 0.f;
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

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = row0 + ty + 16 * i;
        if (row >= n) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = col0 + tx + 16 * j;
            if (col < c) store(df + static_cast<size_t>(row) * c + col, acc[i][j]);
        }
    }
}

template <typename T>
int launch(const void* f, const float* g, int batch, int n, int c, void* df,
           cudaStream_t stream) {
    const dim3 grid((n + kTile - 1) / kTile, (c + kTile - 1) / kTile, batch);
    gram_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(f), g, n, c, static_cast<T*>(df));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// f, df: (batch, n, c) row-major, dtype 0 = float32, 1 = bfloat16;
// g: (batch, c, c) float32. Returns the cudaError_t of the launch
// (0 = success).
int astt_gram_bwd(const void* f, int dtype, const float* g, int batch, int n,
                  int c, void* df, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(f, g, batch, n, c, df, s);
    if (dtype == 1) return launch<__nv_bfloat16>(f, g, batch, n, c, df, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
