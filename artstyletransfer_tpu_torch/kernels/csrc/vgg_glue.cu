// VGG19's element-wise work between its cuDNN convolutions, for Hopper
// (sm_90a): one pass forward and one pass backward per convolution.
//
// Replaces no TPU kernel: the JAX package leaves the bias, ReLU and 2x2
// max-pool around each convolution (artstyletransfer_tpu/models/vgg19.py)
// and their gradients to XLA. On the card PyTorch ran them op by op:
// the bias add (cuDNN's path adds it after the convolution), clamp_min,
// the max-pool with int64 indices; backward threshold_backward, the
// pool's backward and autograd's add of a tap's gradient.
//
// Forward (vgg_glue_fwd_kernel), over one convolution's output y,
// (B, H, W, C) in memory (channels_last), with its bias b:
//   pre  = y + b, rounded to T          (written over y where it is a tap)
//   post = relu(pre)                    (clamp_min's: NaN stays NaN)
//   POOL: the 2x2 stride-2 max of post over each window, the first
//   maximum in scan order as F.max_pool2d keeps it (an odd last row or
//   column is dropped), and one code byte per pooled value: the
//   maximum's position in its window (0..3) | 4 where it is > 0. The
//   full-size post is not written.
// Backward (vgg_glue_bwd_kernel), the gradient at y (= at pre), with
// mask(a) = post <= 0 ? 0 : a (threshold_backward's):
//   mask(g)              a plain layer (g: from the next convolution)
//   mask(g + t)          a tap of post: the tap's gradient t added first
//   mask(g) + t          a tap of pre: t added after the mask
//   mask(t)              the last layer, a tap of post (no g)
//   POOL: g at each pooled value goes to the position its code names,
//   as 0 + g (the pool's backward sums into zeros), where the code says
//   > 0; every other position, and a dropped row or column, gets 0.
// The arithmetic is PyTorch's op by op: float math, rounded to T where
// that path stores a tensor of T. float32 addition commutes, so the
// results are that path's bit for bit.
//
// Bound on the H100: memory; a few operations per element. Bytes per
// element of y in float32: forward 8 (12 with pre), on a pool layer
// 5.25 (y read, a quarter of it written, a code byte per pooled value);
// backward 12 (16 with a tap), on a pool layer 5.25.
//
// Design: 16-byte loads and stores along the channel axis (4 float32 or
// 8 bfloat16 channels a thread, C a multiple of that); a block is C / N
// threads across the channels by 256 N / C pixels, or 2x2 windows on a
// pool layer, so each thread keeps its channels' bias in registers while
// it walks a grid-stride loop; no shared memory, no atomics, nothing
// kept between launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// 16 bytes of T as N floats
template <typename T> struct Io;

template <> struct Io<float> {
    static constexpr int N = 4;
    __device__ static void load(const float* p, float* f) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
    }
    __device__ static void store(float* p, const float* f) {
        *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    }
    __device__ static float round(float v) { return v; }
};

template <> struct Io<__nv_bfloat16> {
    static constexpr int N = 8;
    __device__ static uint32_t bits(float v) {
        return __bfloat16_as_ushort(__float2bfloat16_rn(v));
    }
    __device__ static void load(const __nv_bfloat16* p, float* f) {
        const uint4 v = *reinterpret_cast<const uint4*>(p);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            f[2 * k] = __uint_as_float(w[k] << 16);
            f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
        }
    }
    __device__ static void store(__nv_bfloat16* p, const float* f) {
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
            w[k] = bits(f[2 * k]) | (bits(f[2 * k + 1]) << 16);
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    __device__ static float round(float v) { return __uint_as_float(bits(v) << 16); }
};

// N code bytes (4 or 8) at p, N-byte aligned
template <int N> __device__ void store_code(uint8_t* p, const uint32_t* c);
template <> __device__ void store_code<4>(uint8_t* p, const uint32_t* c) {
    *reinterpret_cast<uint32_t*>(p) = c[0] | c[1] << 8 | c[2] << 16 | c[3] << 24;
}
template <> __device__ void store_code<8>(uint8_t* p, const uint32_t* c) {
    *reinterpret_cast<uint2*>(p) = make_uint2(
        c[0] | c[1] << 8 | c[2] << 16 | c[3] << 24,
        c[4] | c[5] << 8 | c[6] << 16 | c[7] << 24);
}
template <int N> __device__ void load_code(const uint8_t* p, uint32_t* c);
template <> __device__ void load_code<4>(const uint8_t* p, uint32_t* c) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = (v >> (8 * k)) & 0xffu;
}
template <> __device__ void load_code<8>(const uint8_t* p, uint32_t* c) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        c[k] = (v.x >> (8 * k)) & 0xffu;
        c[k + 4] = (v.y >> (8 * k)) & 0xffu;
    }
}

// PyTorch's clamp_min(v, 0) on the card: NaN propagates, else ::max
__device__ __forceinline__ float relu(float v) { return isnan(v) ? v : fmaxf(v, 0.f); }

// units: B*H*W pixels, or B*(H/2)*(W/2) windows with POOL. y is read, and
// overwritten with pre where write_pre; out is post (null: not written)
// or the pooled map; code: one byte per pooled value (POOL only).
template <typename T, bool POOL>
__global__ void __launch_bounds__(kThreads)
vgg_glue_fwd_kernel(T* y, const T* __restrict__ bias, int write_pre,
                    T* __restrict__ out, uint8_t* __restrict__ code,
                    int64_t units, int h, int w, int c) {
    constexpr int N = Io<T>::N;
    const int ch = threadIdx.x * N;
    float b[N];
    if (bias) Io<T>::load(bias + ch, b);
    const int ho = h / 2, wo = w / 2;
    const int64_t row = static_cast<int64_t>(w) * c;
    const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.y;
    for (int64_t u = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
         u < units; u += step) {
        if constexpr (!POOL) {
            T* p = y + u * c + ch;
            float v[N];
            Io<T>::load(p, v);
            if (bias) {
#pragma unroll
                for (int k = 0; k < N; ++k) v[k] = Io<T>::round(v[k] + b[k]);
                if (write_pre) Io<T>::store(p, v);
            }
            if (out) {
#pragma unroll
                for (int k = 0; k < N; ++k) v[k] = relu(v[k]);
                Io<T>::store(out + u * c + ch, v);
            }
        } else {
            const int64_t lane = u / (static_cast<int64_t>(ho) * wo);
            const int r = static_cast<int>(u - lane * ho * wo);
            const int i = r / wo, j = r % wo;
            const T* p = y + (lane * h + 2 * i) * row + static_cast<int64_t>(2 * j) * c + ch;
            const int64_t offs[4] = {0, c, row, row + c};
            float best[N];
            uint32_t pos[N];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                float v[N];
                Io<T>::load(p + offs[q], v);
#pragma unroll
                for (int k = 0; k < N; ++k) {
                    const float x = relu(bias ? Io<T>::round(v[k] + b[k]) : v[k]);
                    if (q == 0 || x > best[k] || isnan(x)) {
                        best[k] = x;
                        pos[k] = q;
                    }
                }
            }
#pragma unroll
            for (int k = 0; k < N; ++k) pos[k] |= best[k] > 0.f ? 4u : 0u;
            Io<T>::store(out + u * c + ch, best);
            store_code<N>(code + u * c + ch, pos);
        }
    }
}

// units: B*H*W pixels, or B*ceil(H/2)*ceil(W/2) windows with POOL (the
// last row or column of windows covers a dropped row or column where H
// or W is odd). Without POOL: g (null for the last layer), post, t (null
// without a tap), tap_after; out = the gradient at y. With POOL: g at the
// pooled map, its code; out (B, H, W, C).
template <typename T, bool POOL>
__global__ void __launch_bounds__(kThreads)
vgg_glue_bwd_kernel(const T* __restrict__ g, const T* __restrict__ post,
                    const uint8_t* __restrict__ code, const T* __restrict__ t,
                    int tap_after, T* __restrict__ out, int64_t units, int h,
                    int w, int c) {
    constexpr int N = Io<T>::N;
    const int ch = threadIdx.x * N;
    const int ho = h / 2, wo = w / 2, hc = (h + 1) / 2, wc = (w + 1) / 2;
    const int64_t row = static_cast<int64_t>(w) * c;
    const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.y;
    for (int64_t u = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
         u < units; u += step) {
        if constexpr (!POOL) {
            const int64_t off = u * c + ch;
            float a[N], v[N];
            if (g) Io<T>::load(g + off, a);
            if (t && !tap_after) {
                Io<T>::load(t + off, v);
#pragma unroll
                for (int k = 0; k < N; ++k) a[k] = g ? a[k] + v[k] : v[k];
            }
            Io<T>::load(post + off, v);
#pragma unroll
            for (int k = 0; k < N; ++k) a[k] = v[k] <= 0.f ? 0.f : a[k];
            if (t && tap_after) {
                Io<T>::load(t + off, v);
#pragma unroll
                for (int k = 0; k < N; ++k) a[k] = a[k] + v[k];
            }
            Io<T>::store(out + off, a);
        } else {
            const int64_t lane = u / (static_cast<int64_t>(hc) * wc);
            const int r = static_cast<int>(u - lane * hc * wc);
            const int i = r / wc, j = r % wc;
            const bool live = i < ho && j < wo;
            float v[N];
            uint32_t cb[N];
            if (live) {
                const int64_t off = ((lane * ho + i) * wo + j) * c + ch;
                Io<T>::load(g + off, v);
                load_code<N>(code + off, cb);
            }
            T* p = out + (lane * h + 2 * i) * row + static_cast<int64_t>(2 * j) * c + ch;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if (2 * i + (q >> 1) >= h || 2 * j + (q & 1) >= w) continue;
                float o[N];
#pragma unroll
                for (int k = 0; k < N; ++k)
                    o[k] = live && cb[k] == (4u | q) ? __fadd_rn(0.f, v[k]) : 0.f;
                Io<T>::store(p + (q >> 1) * row + (q & 1) * c, o);
            }
        }
    }
}

template <typename T>
dim3 block_of(int c) {
    const int across = c / Io<T>::N;
    return dim3(across, across < kThreads ? kThreads / across : 1);
}

unsigned grid_of(int64_t units, dim3 block, int max_blocks) {
    const int64_t need = (units + block.y - 1) / block.y;
    return static_cast<unsigned>(need < max_blocks ? need : max_blocks);
}

template <typename T>
int fwd(void* y, const void* bias, int pool, int write_pre, void* out,
        void* code, int lanes, int h, int w, int c, int max_blocks,
        cudaStream_t s) {
    const dim3 block = block_of<T>(c);
    const int64_t units = static_cast<int64_t>(lanes) *
                          (pool ? static_cast<int64_t>(h / 2) * (w / 2)
                                : static_cast<int64_t>(h) * w);
    if (units == 0) return 0;
    const unsigned grid = grid_of(units, block, max_blocks);
    auto* yt = static_cast<T*>(y);
    auto* bt = static_cast<const T*>(bias);
    auto* ot = static_cast<T*>(out);
    auto* ct = static_cast<uint8_t*>(code);
    if (pool)
        vgg_glue_fwd_kernel<T, true><<<grid, block, 0, s>>>(
            yt, bt, write_pre, ot, ct, units, h, w, c);
    else
        vgg_glue_fwd_kernel<T, false><<<grid, block, 0, s>>>(
            yt, bt, write_pre, ot, ct, units, h, w, c);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* g, const void* post, const void* code, const void* t,
        int pool, int tap_after, void* out, int lanes, int h, int w, int c,
        int max_blocks, cudaStream_t s) {
    const dim3 block = block_of<T>(c);
    const int64_t units = static_cast<int64_t>(lanes) *
                          (pool ? static_cast<int64_t>((h + 1) / 2) * ((w + 1) / 2)
                                : static_cast<int64_t>(h) * w);
    if (units == 0) return 0;
    const unsigned grid = grid_of(units, block, max_blocks);
    auto* gt = static_cast<const T*>(g);
    auto* pt = static_cast<const T*>(post);
    auto* ct = static_cast<const uint8_t*>(code);
    auto* tt = static_cast<const T*>(t);
    auto* ot = static_cast<T*>(out);
    if (pool)
        vgg_glue_bwd_kernel<T, true><<<grid, block, 0, s>>>(
            gt, pt, ct, tt, tap_after, ot, units, h, w, c);
    else
        vgg_glue_bwd_kernel<T, false><<<grid, block, 0, s>>>(
            gt, pt, ct, tt, tap_after, ot, units, h, w, c);
    return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int dtype, int c, int max_blocks) {
    const int n = dtype == 0 ? 4 : 8;
    return (dtype == 0 || dtype == 1) && c > 0 && c % n == 0 &&
           c / n <= kThreads && max_blocks > 0;
}

}  // namespace

extern "C" {

// y: (lanes, h, w, c) float32 (dtype 0) or bfloat16 (1), contiguous and
// 16-byte aligned, c a multiple of 16 bytes' worth of elements and at
// most 256 times that; bias: (c,) of the same dtype, or null (none: y
// is pre). pool 0: out (lanes, h, w, c) = relu(y + bias), or null;
// write_pre: y + bias is written over y. pool 1 (h, w >= 2): out
// (lanes, h/2, w/2, c) the pooled map and code (lanes, h/2, w/2, c)
// bytes. At most max_blocks blocks. Launches on `stream` (the current
// device); returns the cudaError_t of the launch (0 = success).
int astt_vgg_glue_fwd(void* y, const void* bias, int dtype, int pool,
                      int write_pre, void* out, void* code, int lanes, int h,
                      int w, int c, int max_blocks, void* stream) {
    if (!shape_ok(dtype, c, max_blocks) || (pool && (h < 2 || w < 2)))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype == 0
               ? fwd<float>(y, bias, pool, write_pre, out, code, lanes, h, w, c,
                            max_blocks, s)
               : fwd<__nv_bfloat16>(y, bias, pool, write_pre, out, code, lanes,
                                    h, w, c, max_blocks, s);
}

// The gradient at y, out (lanes, h, w, c), of a layer whose forward had
// (lanes, h, w, c) y. pool 0: g (null: none), post, t (null: none) all
// (lanes, h, w, c); tap_after: t is added after the mask. pool 1: g and
// code (lanes, h/2, w/2, c). Without g, t must be a tap of post (its
// gradient alone, masked). Types, layout and launch as above.
int astt_vgg_glue_bwd(const void* g, const void* post, const void* code,
                      const void* t, int dtype, int pool, int tap_after,
                      void* out, int lanes, int h, int w, int c,
                      int max_blocks, void* stream) {
    if (!shape_ok(dtype, c, max_blocks) || (pool && (h < 2 || w < 2)) ||
        (!pool && !g && (!t || tap_after)))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype == 0
               ? bwd<float>(g, post, code, t, pool, tap_after, out, lanes, h, w,
                            c, max_blocks, s)
               : bwd<__nv_bfloat16>(g, post, code, t, pool, tap_after, out,
                                    lanes, h, w, c, max_blocks, s);
}

}  // extern "C"
