// Squared-mean total variation for Hopper (sm_90a): forward and backward,
// one launch each for every lane of a batch.
//
// Replaces the TPU kernel artstyletransfer_tpu/ops/pallas_kernels.py
// `_tv_kernel` with what surrounds it in `_tv_impl` (`_tv_means` and the
// squares of the forward; `_tv_vjp_bwd` with `_dx_part` / `_dy_part`, which
// the JAX package leaves to XLA, for the backward), vmapped over the lanes.
// Over the (h, W = w*c) view of each NHWC float32 image b of a batch:
//   mean_x[b] = sum |y[i, j] - y[i, j + c]| / (h (w-1) c)
//   mean_y[b] = sum |y[i, j] - y[i + 1, j]| / ((h-1) w c)
//   tv[b]     = mean_x^2 + mean_y^2
//   grad[b, i, j] = a_x (sx(i, j) - sx(i, j - c)) + a_y (sy(i, j) - sy(i - 1, j))
// with sx(i, j) = sign(y[i, j] - y[i, j + c]) (0 where j + c >= W),
// sy(i, j) = sign(y[i, j] - y[i + 1, j]) (0 on the last row), sign(0) = 0,
// a_x = g 2 mean_x / (h (w-1) c) and a_y = g 2 mean_y / ((h-1) w c).
//
// A seam (space sharding: one image's rows over several devices, each
// launch one block of rows). Both kernels take h_total, the image's
// height for the denominators in place of h, and an optional halo row:
// the next block's first row, (lanes, W). The forward then adds
// sum |y[h-1, j] - halo[j]| to the vertical sum and returns each lane's
// partial means (its sums over h_total's denominators), which add up over
// the blocks to the image's means (tv is then the square of a partial and
// not used). The backward, given the image's means, writes the block's
// gradient, with the seam pair's part on its last row, and the halo
// row's gradient -a_y sign(y[h-1, j] - halo[j]), which belongs to the
// next block's first row. The block's first row has no pair above: that
// pair is the previous block's seam. Without a halo and with h_total = h
// both kernels are the whole-image kernels, bit for bit.
//
// Bound on the H100: memory. The forward reads 4 bytes per element, the
// backward reads 4 and writes 4; a few operations per element.
//
// Design. A warp owns a segment of one row's columns and walks down a strip
// of rows, VEC floats per lane (VEC = 4, 16-byte accesses, when rows start
// on 16-byte boundaries, i.e. W % 4 == 0; else 2 or 1). Each thread streams
// its rows through its own ring of kRing slots in shared memory filled by
// cp.async, so kRing - 1 rows per thread are in flight without holding
// registers. Units of work go round-robin over the blocks, so that every
// SM of the grid has a share. The previous (and for the backward the next) row of its
// columns stays in registers, so the vertical neighbour is free; the
// horizontal neighbour at +-c comes from a lane at most ceil(c / VEC)
// away by a shuffle. c is a template parameter, so every neighbour's lane
// and component are fixed at compile time. The segments overlap by those
// halo lanes, which load but own nothing, so no lane loads a neighbour
// again and nothing divides per element; the masked tail is the lanes past
// the row's end. A strip re-reads one row (forward) or two (backward) at
// its edges.
//
// Forward: one thread block cluster per lane (grid (cluster, lanes),
// cluster (cluster, 1, 1)). Each thread sums its |differences| in float, a
// warp by shuffles, a block in double through shared memory; each
// block stores its pair into rank 0's shared memory (distributed shared
// memory), and after one cluster barrier rank 0 sums the pairs in rank
// order and writes (tv, mean_x, mean_y, sum_x, sum_y). Fixed orders: no
// atomics, the same bits on every call, no state kept between calls,
// nothing synchronises with the host.
//
// Backward: grid (blocks, lanes), no cluster; each warp writes the grad of
// its strip of its segment, VEC floats per lane; a_x and a_y are formed in
// the kernel from g and the forward's means.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxFwdThreads = 1024;
constexpr int kMaxBwdThreads = 512;
constexpr int kMaxCluster = 16;
constexpr int kRing = 8;          // row slots per thread (power of 2)
constexpr int kMaxDevices = 64;

// bytes of the rings of a block of `threads` threads
constexpr int ring_bytes(int threads, int vec) { return kRing * threads * vec * 4; }

// VEC floats from global to shared memory, asynchronously; zeros where
// `in` is false (src-size 0: nothing is read)
template <int VEC>
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool in) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int bytes = in ? 4 * VEC : 0;
    if constexpr (VEC == 4)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(d), "l"(src), "r"(bytes) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                     :: "r"(d), "l"(src), "n"(4 * VEC), "r"(bytes) : "memory");
}

__device__ __forceinline__ void commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void wait_groups() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <int VEC>
__device__ __forceinline__ void load_shared(const float* p, float (&v)[VEC]) {
    if constexpr (VEC == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else if constexpr (VEC == 2) {
        const float2 t = *reinterpret_cast<const float2*>(p);
        v[0] = t.x; v[1] = t.y;
    } else {
        v[0] = p[0];
    }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
    if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (VEC == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
        p[0] = v[0];
    }
}

// nb[k] = the value C columns right of this lane's element k: lane
// + (k + C) / VEC, component (k + C) % VEC. Lanes whose neighbour is past
// the warp read their own value; they are halo lanes and own nothing.
template <int VEC, int C>
__device__ __forceinline__ void right_of(const float (&v)[VEC], float (&nb)[VEC]) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
        const int dq = (k + C) / VEC, comp = (k + C) % VEC;
        nb[k] = dq == 0 ? v[comp] : __shfl_down_sync(kFull, v[comp], dq);
    }
}

// nb[k] = the value C columns left of element k: lane - dq, where
// k - C = comp - dq VEC with 0 <= comp < VEC
template <int VEC, int C>
__device__ __forceinline__ void left_of(const float (&v)[VEC], float (&nb)[VEC]) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
        const int t = k - C + 8 * VEC;   // >= 0
        const int dq = 8 - t / VEC, comp = t % VEC;
        nb[k] = dq == 0 ? v[comp] : __shfl_up_sync(kFull, v[comp], dq);
    }
}

__device__ __forceinline__ float sgn(float d) {
    // sign(0) = 0, a NaN stays NaN (as torch.sign and jnp.sign)
    return d > 0.f ? 1.f : (d < 0.f ? -1.f : d);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
    return v;
}

// this block's share of a lane's units (unit u = warp * gridDim.x +
// blockIdx.x + k * gridDim.x * nwarps) summed: (sum |dx|, sum |dy|) in
// double, in thread 0 only
template <int VEC, int C>
__device__ __forceinline__ void fwd_block_sums(const float* __restrict__ img,
                                               const float* __restrict__ halo,
                                               int h, int W, int rows,
                                               double& tx, double& ty) {
    constexpr int kHalo = (C + VEC - 1) / VEC;   // right halo lanes
    constexpr int kSegCols = (32 - kHalo) * VEC;
    extern __shared__ __align__(16) float ring[];
    __shared__ float red[2][kMaxFwdThreads / 32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    float* const first = ring + threadIdx.x * VEC;   // slot s: + s * stride
    const int stride = blockDim.x * VEC;
    const int nseg = (W + kSegCols - 1) / kSegCols;
    const int nunits = nseg * ((h + rows - 1) / rows);
    const int h_rows = h + (halo != nullptr);   // rows read: + the halo row

    // one running sum per element of the lane: independent add chains
    float sx[VEC] = {}, sy[VEC] = {};
    for (int u = warp * gridDim.x + blockIdx.x; u < nunits;
         u += gridDim.x * nwarps) {
        const int strip = u / nseg;
        const int j0 = (u - strip * nseg) * kSegCols + lane * VEC;
        const bool in = j0 < W;
        const bool mine = lane < 32 - kHalo && in;
        bool right[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) right[k] = mine && j0 + k + C < W;
        const int r0 = strip * rows;
        const int owned = min(rows, h - r0);            // rows [r0, r0 + owned)
        const int nrows = min(owned + 1, h_rows - r0);  // + the row below
        const int col = in ? j0 : 0;
        // row r of the image, or the halo row at r == h
        auto row = [&](int r) {
            return (r < h ? img + static_cast<int64_t>(r) * W : halo) + col;
        };
#pragma unroll
        for (int s = 0; s < kRing; ++s) {
            if (s < nrows) copy_async<VEC>(first + s * stride, row(r0 + s), in);
            commit();
        }
        float prev[VEC];
        for (int t0 = 0; t0 < nrows; t0 += kRing) {
#pragma unroll
            for (int i = 0; i < kRing; ++i) {   // row t0 + i, in slot i
                const int t = t0 + i;
                if (t >= nrows) break;
                float* slot = first + i * stride;
                wait_groups<kRing - 1>();
                float v[VEC];
                load_shared<VEC>(slot, v);
                if (t > 0 && mine) {
#pragma unroll
                    for (int k = 0; k < VEC; ++k) sy[k] += fabsf(prev[k] - v[k]);
                }
                if (t < owned) {   // uniform over the warp
                    float nb[VEC];
                    right_of<VEC, C>(v, nb);
#pragma unroll
                    for (int k = 0; k < VEC; ++k)
                        if (right[k]) sx[k] += fabsf(v[k] - nb[k]);
                }
#pragma unroll
                for (int k = 0; k < VEC; ++k) prev[k] = v[k];
                // the slot is refilled only after its values were used
                if (t + kRing < nrows) copy_async<VEC>(slot, row(r0 + t + kRing), in);
                commit();
            }
        }
    }
    wait_groups<0>();

    float bx = 0.f, by = 0.f;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
        bx += sx[k];
        by += sy[k];
    }
    bx = warp_sum(bx);
    by = warp_sum(by);
    if (lane == 0) {
        red[0][warp] = bx;
        red[1][warp] = by;
    }
    __syncthreads();
    tx = ty = 0.0;
    if (threadIdx.x == 0) {
        for (int w = 0; w < nwarps; ++w) {
            tx += red[0][w];
            ty += red[1][w];
        }
    }
}

// grid (cluster, lanes), one cluster per lane; out: (lanes, 5) =
// (tv, mean_x, mean_y, sum_x, sum_y); halo: (lanes, W) or null
template <int VEC, int C>
__global__ void __launch_bounds__(kMaxFwdThreads, 1)
tv_fwd_kernel(const float* __restrict__ y, const float* __restrict__ halo,
              int h, int h_total, int W, int rows, float* __restrict__ out) {
    __shared__ double parts[kMaxCluster][2];   // rank 0's: every block's pair
    cg::cluster_group cluster = cg::this_cluster();
    // a block may store into another's shared memory only once that block
    // runs: arrive now, wait before the store
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    double tx, ty;
    fwd_block_sums<VEC, C>(y + static_cast<int64_t>(blockIdx.y) * h * W,
                           halo ? halo + static_cast<int64_t>(blockIdx.y) * W
                                : nullptr,
                           h, W, rows, tx, ty);
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (threadIdx.x == 0) {
        double* p = cluster.map_shared_rank(&parts[cluster.block_rank()][0], 0);
        p[0] = tx;
        p[1] = ty;
    }
    cluster.sync();   // rank 0 holds every block's pair
    if (cluster.block_rank() == 0 && threadIdx.x == 0) {
        tx = ty = 0.0;
        for (unsigned r = 0; r < cluster.num_blocks(); ++r) {
            tx += parts[r][0];
            ty += parts[r][1];
        }
        const int w = W / C;
        const double mx = tx / (static_cast<double>(h_total) * (w - 1) * C);
        const double my = ty / (static_cast<double>(h_total - 1) * w * C);
        float* o = out + 5 * static_cast<int64_t>(blockIdx.y);
        o[0] = static_cast<float>(mx * mx + my * my);
        o[1] = static_cast<float>(mx);
        o[2] = static_cast<float>(my);
        o[3] = static_cast<float>(tx);
        o[4] = static_cast<float>(ty);
    }
}

// the grad of row r of a warp's segment from rows r - 1 (up), r (cur) and
// r + 1 (dn); every lane calls it (shuffles), owners store
template <int VEC, int C>
__device__ __forceinline__ void bwd_row(const float (&up)[VEC],
                                        const float (&cur)[VEC],
                                        const float (&dn)[VEC],
                                        const bool (&right)[VEC],
                                        const bool (&left)[VEC], bool mine,
                                        bool has_up, bool has_dn, float ax,
                                        float ay, float* dst) {
    float nr[VEC], nl[VEC];
    right_of<VEC, C>(cur, nr);
    left_of<VEC, C>(cur, nl);
    if (!mine) return;
    float o[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
        const float dx = (right[k] ? sgn(cur[k] - nr[k]) : 0.f)
                         - (left[k] ? sgn(nl[k] - cur[k]) : 0.f);
        const float dy = (has_dn ? sgn(cur[k] - dn[k]) : 0.f)
                         - (has_up ? sgn(up[k] - cur[k]) : 0.f);
        o[k] = ax * dx + ay * dy;
    }
    store_vec<VEC>(dst, o);
}

// grid (blocks, lanes); grad: (lanes, h, W). g[b * g_stride] is lane b's
// cotangent, means[b * m_stride + {0, 1}] its (mean_x, mean_y). halo:
// (lanes, W) or null; halo_grad: (lanes, W), written where halo is given.
template <int VEC, int C>
__global__ void __launch_bounds__(kMaxBwdThreads)
tv_bwd_kernel(const float* __restrict__ y, const float* __restrict__ g,
              int64_t g_stride, const float* __restrict__ means,
              int64_t m_stride, const float* __restrict__ halo, int h,
              int h_total, int W, int rows, float* __restrict__ grad,
              float* __restrict__ halo_grad) {
    constexpr int kHalo = (C + VEC - 1) / VEC;   // on each side
    constexpr int kSegCols = (32 - 2 * kHalo) * VEC;
    extern __shared__ __align__(16) float ring[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const int64_t b = blockIdx.y;
    const float* img = y + b * h * W;
    const float* hrow = halo ? halo + b * W : nullptr;
    float* dst = grad + b * h * W;
    float* slots = ring + (warp * kRing * 32 + lane) * VEC;   // slot s: + s * 32 VEC
    constexpr int stride = 32 * VEC;

    const int w = W / C;
    const float gb = g[b * g_stride];
    const float ax = gb * (2.f * means[b * m_stride]) /
                     (static_cast<float>(h_total) * (w - 1) * C);
    const float ay = gb * (2.f * means[b * m_stride + 1]) /
                     (static_cast<float>(h_total - 1) * w * C);
    const int nseg = (W + kSegCols - 1) / kSegCols;
    const int nunits = nseg * ((h + rows - 1) / rows);
    const int h_rows = h + (halo != nullptr);   // rows read: + the halo row

    for (int u = warp * gridDim.x + blockIdx.x; u < nunits;
         u += gridDim.x * nwarps) {
        const int strip = u / nseg;
        const int j0 = (u - strip * nseg) * kSegCols + (lane - kHalo) * VEC;
        const bool in = j0 >= 0 && j0 < W;
        const bool mine = lane >= kHalo && lane < 32 - kHalo && in;
        bool right[VEC], left[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            right[k] = j0 + k + C < W;
            left[k] = j0 + k >= C;
        }
        const int r0 = strip * rows;
        const int r1 = min(r0 + rows, h);        // rows [r0, r1) written
        const int ra = max(r0 - 1, 0);           // rows [ra, rb] read
        const int rb = min(r1, h_rows - 1);      // row h: the halo row
        const int nrows = rb - ra + 1;
        const int col = in ? j0 : 0;
        auto row = [&](int r) {
            return (r < h ? img + static_cast<int64_t>(r) * W : hrow) + col;
        };
#pragma unroll
        for (int s = 0; s < kRing; ++s) {
            if (s < nrows) copy_async<VEC>(slots + s * stride, row(ra + s), in);
            commit();
        }
        float up[VEC], cur[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) up[k] = cur[k] = 0.f;
        for (int t = 0; t < nrows; ++t) {
            wait_groups<kRing - 1>();
            float* slot = slots + (t & (kRing - 1)) * stride;
            float v[VEC];
            load_shared<VEC>(slot, v);
            const int rr = ra + t;               // the row that arrived
            if (rr > r0)                         // uniform: row rr - 1 is whole
                bwd_row<VEC, C>(up, cur, v, right, left, mine, rr - 1 > 0, true,
                                ax, ay, dst + static_cast<int64_t>(rr - 1) * W + j0);
            if (rr == h && mine) {               // the halo row: the seam pair's part
                float o[VEC];
#pragma unroll
                for (int k = 0; k < VEC; ++k) o[k] = -ay * sgn(cur[k] - v[k]);
                store_vec<VEC>(halo_grad + b * W + j0, o);
            }
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
                up[k] = cur[k];
                cur[k] = v[k];
            }
            if (t + kRing < nrows) copy_async<VEC>(slot, row(ra + t + kRing), in);
            commit();
        }
        if (rb == r1 - 1) {   // the strip ends at the last row: no row below
            const float none[VEC] = {};
            bwd_row<VEC, C>(up, cur, none, right, left, mine, rb > 0, false, ax,
                            ay, dst + static_cast<int64_t>(rb) * W + j0);
        }
    }
    wait_groups<0>();
}

cudaError_t finish(cudaError_t err) {
    // clear the thread's last error, so that a refused launch is reported
    // by this call and not by the next
    const cudaError_t last = cudaGetLastError();
    return err != cudaSuccess ? err : last;
}

template <int VEC, int C>
struct Fwd {
    // per device, once: clusters of 16 and rings above 48 KB
    static cudaError_t prepare(int dev) {
        static bool done[kMaxDevices] = {};
        if (dev >= 0 && dev < kMaxDevices && done[dev]) return cudaSuccess;
        cudaError_t err = cudaFuncSetAttribute(
            tv_fwd_kernel<VEC, C>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                tv_fwd_kernel<VEC, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                ring_bytes(kMaxFwdThreads, VEC));
        if (err == cudaSuccess && dev >= 0 && dev < kMaxDevices) done[dev] = true;
        return err;
    }

    static void config(int lanes, int cluster, int warps, cudaStream_t s,
                       cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
        *cfg = cudaLaunchConfig_t{};
        cfg->gridDim = dim3(cluster, lanes, 1);
        cfg->blockDim = dim3(32 * warps, 1, 1);
        cfg->dynamicSmemBytes = ring_bytes(32 * warps, VEC);
        cfg->stream = s;
        attr->id = cudaLaunchAttributeClusterDimension;
        attr->val.clusterDim.x = cluster;
        attr->val.clusterDim.y = 1;
        attr->val.clusterDim.z = 1;
        cfg->attrs = attr;
        cfg->numAttrs = 1;
    }

    static int launch(const float* y, const float* halo, int lanes, int h,
                      int h_total, int W, int cluster, int warps, int rows,
                      float* out, cudaStream_t s, int dev) {
        cudaError_t err = prepare(dev);
        if (err == cudaSuccess) {
            cudaLaunchConfig_t cfg;
            cudaLaunchAttribute attr;
            config(lanes, cluster, warps, s, &cfg, &attr);
            err = cudaLaunchKernelEx(&cfg, tv_fwd_kernel<VEC, C>, y, halo, h,
                                     h_total, W, rows, out);
        }
        return static_cast<int>(finish(err));
    }

    static int clusters(int cluster, int warps, int dev, int* n) {
        cudaError_t err = prepare(dev);
        if (err == cudaSuccess) {
            cudaLaunchConfig_t cfg;
            cudaLaunchAttribute attr;
            config(1, cluster, warps, nullptr, &cfg, &attr);
            err = cudaOccupancyMaxActiveClusters(n, tv_fwd_kernel<VEC, C>, &cfg);
        }
        return static_cast<int>(finish(err));
    }
};

template <int VEC, int C>
struct Bwd {
    static int launch(const float* y, const float* g, int64_t g_stride,
                      const float* means, int64_t m_stride, const float* halo,
                      int lanes, int h, int h_total, int W, int blocks,
                      int warps, int rows, float* grad, float* halo_grad,
                      cudaStream_t s, int dev) {
        static bool done[kMaxDevices] = {};   // rings above 48 KB, once
        cudaError_t err = cudaSuccess;
        if (!(dev >= 0 && dev < kMaxDevices && done[dev])) {
            err = cudaFuncSetAttribute(
                tv_bwd_kernel<VEC, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                ring_bytes(kMaxBwdThreads, VEC));
            if (err == cudaSuccess && dev >= 0 && dev < kMaxDevices) done[dev] = true;
        }
        if (err == cudaSuccess)
            tv_bwd_kernel<VEC, C><<<dim3(blocks, lanes), 32 * warps,
                                    ring_bytes(32 * warps, VEC), s>>>(
                y, g, g_stride, means, m_stride, halo, h, h_total, W, rows,
                grad, halo_grad);
        return static_cast<int>(finish(err));
    }
};

// return Op<vec, c>::f(...) for vec in {4, 2, 1} and c in 1..4
#define ASTT_TV_DISPATCH(Op, f, ...)                 \
    switch (vec * 8 + c) {                           \
        case 33: return Op<4, 1>::f(__VA_ARGS__);    \
        case 34: return Op<4, 2>::f(__VA_ARGS__);    \
        case 35: return Op<4, 3>::f(__VA_ARGS__);    \
        case 36: return Op<4, 4>::f(__VA_ARGS__);    \
        case 17: return Op<2, 1>::f(__VA_ARGS__);    \
        case 18: return Op<2, 2>::f(__VA_ARGS__);    \
        case 19: return Op<2, 3>::f(__VA_ARGS__);    \
        case 20: return Op<2, 4>::f(__VA_ARGS__);    \
        case 9: return Op<1, 1>::f(__VA_ARGS__);     \
        case 10: return Op<1, 2>::f(__VA_ARGS__);    \
        case 11: return Op<1, 3>::f(__VA_ARGS__);    \
        case 12: return Op<1, 4>::f(__VA_ARGS__);    \
    }                                                \
    return static_cast<int>(cudaErrorInvalidValue)

// run f on device dev, restoring the caller's current device
template <typename F>
int on_device(int dev, F f) {
    int cur = -1;
    cudaError_t err = cudaGetDevice(&cur);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (cur != dev && (err = cudaSetDevice(dev)) != cudaSuccess)
        return static_cast<int>(err);
    const int rc = f();
    if (cur != dev) cudaSetDevice(cur);
    return rc;
}

}  // namespace

extern "C" {

// y: (lanes, h, w, c) float32 contiguous, 1 <= c <= 4, W = w c,
// W % vec == 0 and y aligned to 4 vec bytes (vec 4, 2 or 1); halo: null,
// or (lanes, W) float32 contiguous and aligned as y (a seam: see the top
// of this file); h_total: the image's height for the means (h for a whole
// image); `cluster` (1..16) blocks of `warps` (1..32) warps per lane;
// `rows` per strip. out: (lanes, 5) float32 = (tv, mean_x, mean_y,
// sum_x, sum_y) of each lane. Launches on `stream` of device `dev`.
// Returns the cudaError_t of the launch (0 = success).
int astt_tv_fwd(const float* y, const float* halo, int lanes, int h,
                int h_total, int w, int c, int vec, int cluster, int warps,
                int rows, float* out, int dev, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int W = w * c;
    if (cluster < 1 || cluster > kMaxCluster || warps < 1 ||
        warps > kMaxFwdThreads / 32 || h_total < 2)
        return static_cast<int>(cudaErrorInvalidValue);
    return on_device(dev, [&]() -> int {
        ASTT_TV_DISPATCH(Fwd, launch, y, halo, lanes, h, h_total, W, cluster,
                         warps, rows, out, s, dev);
    });
}

// *n = how many clusters of `cluster` forward blocks of `warps` warps the
// device holds at once (0: such a cluster cannot launch)
int astt_tv_fwd_clusters(int vec, int c, int cluster, int warps, int dev,
                         int* n) {
    return on_device(dev, [&]() -> int {
        ASTT_TV_DISPATCH(Fwd, clusters, cluster, warps, dev, n);
    });
}

// y, halo and h_total as for astt_tv_fwd; g: lane b's cotangent at
// g[b * g_stride]; means: lane b's (mean_x, mean_y) of the whole image at
// means[b * m_stride + {0, 1}]; grid (blocks, lanes) of `warps` (1..16)
// warps, `rows` per strip. grad: (lanes, h, w, c) float32, aligned as y;
// halo_grad: (lanes, W) float32 aligned as y, written when halo is given.
int astt_tv_bwd(const float* y, const float* g, int64_t g_stride,
                const float* means, int64_t m_stride, const float* halo,
                int lanes, int h, int h_total, int w, int c, int vec,
                int blocks, int warps, int rows, float* grad,
                float* halo_grad, int dev, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int W = w * c;
    if (warps < 1 || warps > kMaxBwdThreads / 32 || h_total < 2 ||
        (halo != nullptr && halo_grad == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    return on_device(dev, [&]() -> int {
        ASTT_TV_DISPATCH(Bwd, launch, y, g, g_stride, means, m_stride, halo,
                         lanes, h, h_total, W, blocks, warps, rows, grad,
                         halo_grad, s, dev);
    });
}

}  // extern "C"
