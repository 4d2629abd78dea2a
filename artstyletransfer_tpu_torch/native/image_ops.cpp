// Native host-side image ops for artstyletransfer_tpu_torch.
//
// The reference delegates its host-side image work to OpenCV's C++ core
// (cv2.resize INTER_CUBIC at reference neural_style_transfer.py:226/:304/
// :427, cv2.Sobel/GaussianBlur at :331-340). This library provides the
// framework's own native implementations with identical semantics:
//   - bicubic resize: Keys cubic kernel a=-0.75, half-pixel centers,
//     replicate border (exactly cv2 INTER_CUBIC / torch bicubic)
//   - separable correlation with REFLECT_101 borders (cv2's default),
//     used for Sobel ksize=5 and Gaussian blur
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).
// Exact parity with the numpy fallbacks is enforced by tests.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kA = -0.75;  // cubic kernel sharpness (cv2/torch)

inline double cubic(double x) {
    x = std::fabs(x);
    if (x <= 1.0) return (kA + 2.0) * x * x * x - (kA + 3.0) * x * x + 1.0;
    if (x < 2.0)  return kA * (x * x * x - 5.0 * x * x + 8.0 * x - 4.0);
    return 0.0;
}

struct Taps {
    std::vector<int32_t> idx;    // n_out * 4 clamped source indices
    std::vector<float> w;        // n_out * 4 weights
};

Taps make_taps(int n_in, int n_out) {
    Taps t;
    t.idx.resize(static_cast<size_t>(n_out) * 4);
    t.w.resize(static_cast<size_t>(n_out) * 4);
    const double scale = static_cast<double>(n_in) / n_out;
    for (int i = 0; i < n_out; ++i) {
        const double src = (i + 0.5) * scale - 0.5;
        const int base = static_cast<int>(std::floor(src));
        const double frac = src - base;
        for (int tap = -1; tap <= 2; ++tap) {
            const int k = tap + 1;
            t.idx[static_cast<size_t>(i) * 4 + k] =
                std::min(std::max(base + tap, 0), n_in - 1);
            t.w[static_cast<size_t>(i) * 4 + k] =
                static_cast<float>(cubic(frac - tap));
        }
    }
    return t;
}

// REFLECT_101 index: ...cb|abcdef|ed...
inline int mirror101(int i, int n) {
    if (n == 1) return 0;
    const int period = 2 * (n - 1);
    i = std::abs(i) % period;
    return i < n ? i : period - i;
}

}  // namespace

extern "C" {

// in:  (h, w, c) float32, C-contiguous. out: (oh, ow, c) float32.
void astt_bicubic_resize(const float* in, int h, int w, int c,
                         float* out, int oh, int ow) {
    const Taps ty = make_taps(h, oh);
    const Taps tx = make_taps(w, ow);
    // horizontal pass first into a (h, ow, c) temp, then vertical
    std::vector<float> tmp(static_cast<size_t>(h) * ow * c);
    for (int y = 0; y < h; ++y) {
        const float* row = in + static_cast<size_t>(y) * w * c;
        float* trow = tmp.data() + static_cast<size_t>(y) * ow * c;
        for (int j = 0; j < ow; ++j) {
            const int32_t* xi = tx.idx.data() + static_cast<size_t>(j) * 4;
            const float* xw = tx.w.data() + static_cast<size_t>(j) * 4;
            for (int ch = 0; ch < c; ++ch) {
                trow[static_cast<size_t>(j) * c + ch] =
                    xw[0] * row[static_cast<size_t>(xi[0]) * c + ch] +
                    xw[1] * row[static_cast<size_t>(xi[1]) * c + ch] +
                    xw[2] * row[static_cast<size_t>(xi[2]) * c + ch] +
                    xw[3] * row[static_cast<size_t>(xi[3]) * c + ch];
            }
        }
    }
    const size_t stride = static_cast<size_t>(ow) * c;
    for (int i = 0; i < oh; ++i) {
        const int32_t* yi = ty.idx.data() + static_cast<size_t>(i) * 4;
        const float* yw = ty.w.data() + static_cast<size_t>(i) * 4;
        const float* r0 = tmp.data() + static_cast<size_t>(yi[0]) * stride;
        const float* r1 = tmp.data() + static_cast<size_t>(yi[1]) * stride;
        const float* r2 = tmp.data() + static_cast<size_t>(yi[2]) * stride;
        const float* r3 = tmp.data() + static_cast<size_t>(yi[3]) * stride;
        float* orow = out + static_cast<size_t>(i) * stride;
        for (size_t k = 0; k < stride; ++k) {
            orow[k] = yw[0] * r0[k] + yw[1] * r1[k] +
                      yw[2] * r2[k] + yw[3] * r3[k];
        }
    }
}

// Separable correlation, REFLECT_101 borders, float64 (matches the numpy
// fallback's precision). in/out: (h, w, c); kx/ky: odd-length kernels.
void astt_sep_filter_reflect101(const double* in, int h, int w, int c,
                                const double* kx, int nkx,
                                const double* ky, int nky, double* out) {
    const int ry = nky / 2;
    const int rx = nkx / 2;
    const size_t rowstride = static_cast<size_t>(w) * c;
    // vertical pass
    std::vector<double> tmp(static_cast<size_t>(h) * rowstride, 0.0);
    for (int y = 0; y < h; ++y) {
        double* trow = tmp.data() + static_cast<size_t>(y) * rowstride;
        for (int t = 0; t < nky; ++t) {
            const int sy = mirror101(y + t - ry, h);
            const double kv = ky[t];
            if (kv == 0.0) continue;
            const double* srow = in + static_cast<size_t>(sy) * rowstride;
            for (size_t k = 0; k < rowstride; ++k) trow[k] += kv * srow[k];
        }
    }
    // horizontal pass
    std::memset(out, 0, sizeof(double) * h * rowstride);
    for (int y = 0; y < h; ++y) {
        const double* trow = tmp.data() + static_cast<size_t>(y) * rowstride;
        double* orow = out + static_cast<size_t>(y) * rowstride;
        for (int x = 0; x < w; ++x) {
            for (int t = 0; t < nkx; ++t) {
                const int sx = mirror101(x + t - rx, w);
                const double kv = kx[t];
                if (kv == 0.0) continue;
                for (int ch = 0; ch < c; ++ch) {
                    orow[static_cast<size_t>(x) * c + ch] +=
                        kv * trow[static_cast<size_t>(sx) * c + ch];
                }
            }
        }
    }
}

int astt_native_abi_version(void) { return 1; }

}  // extern "C"
