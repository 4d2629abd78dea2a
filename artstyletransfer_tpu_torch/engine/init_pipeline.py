"""Initial-image construction: structured, style-derived, gradient-modulated,
Gaussian-enveloped noise.

Host-side, one-time-per-job numpy code (it never runs in the hot loop). All
image-processing primitives (Gaussian kernels, Sobel, blur) are implemented
natively here rather than delegated to OpenCV; unit tests check them against
cv2 where available.

Reference parity:
- gaussian_mask: vignette from the outer product of discrete Gaussian
  kernels, normalized at the center; mask = peripheral + norm*(central -
  peripheral) (reference neural_style_transfer.py:396-418)
- make_style_noise: style image resized to the noise grid, pixels randomly
  permuted — noise with exactly the style's color distribution (reference
  neural_style_transfer.py:422-439)
- multi-level noise map: per noise level, granularity > 0 = spot count along
  the shortest axis, < 0 = fixed spot size in px, == 0 = constant brightness
  layer; low-res noise upscaled bicubically, multiplied by its Gaussian
  envelope, accumulated (reference neural_style_transfer.py:265-313)
- gradient-aware weighting: Sobel(ksize=5) magnitude clipped to [0,100],
  blurred (101-tap Gaussian, sigma=0.2), noise_replacement =
  5*noise_factor/(5+|grad|) (reference neural_style_transfer.py:325-343)
- init selection: 'random' -> noise*0.5; 'content+noise' -> blend;
  'style' -> resized style (reference neural_style_transfer.py:349-362)
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..config import Config
from ..ops.resize import bicubic_resize_np

# ---------------------------------------------------------------------------
# Native image-processing primitives (cv2-equivalent semantics)
# ---------------------------------------------------------------------------


def gaussian_kernel_1d(n: int, sigma: float) -> np.ndarray:
    """Discrete Gaussian kernel, sum=1 (cv2.getGaussianKernel semantics).

    For sigma <= 0 cv2 derives sigma = 0.3*((n-1)*0.5 - 1) + 0.8.
    """
    if sigma <= 0:
        sigma = 0.3 * ((n - 1) * 0.5 - 1) + 0.8
    x = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float64)


def _sep_filter_reflect101(img: np.ndarray, kx: np.ndarray, ky: np.ndarray) -> np.ndarray:
    """Separable 2-D correlation with BORDER_REFLECT_101 (cv2 default).

    scipy.ndimage.correlate1d with mode='mirror' implements exactly
    REFLECT_101 edge handling at C speed; a pure-numpy fallback keeps the
    dependency optional.
    """
    img = np.asarray(img, dtype=np.float64)
    from ..native import available as native_available
    from ..native import sep_filter_reflect101 as native_filter

    if img.ndim == 3 and native_available():
        return native_filter(img, kx=np.asarray(kx), ky=np.asarray(ky))
    try:
        from scipy.ndimage import correlate1d

        out = correlate1d(img, ky, axis=0, mode="mirror")
        return correlate1d(out, kx, axis=1, mode="mirror")
    except ImportError:
        pass
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    ry, rx = len(ky) // 2, len(kx) // 2
    # vertical pass
    pad = np.pad(img, ((ry, ry), (0, 0), (0, 0)), mode="reflect")
    out = np.zeros_like(img)
    for i, w in enumerate(ky):
        out += w * pad[i:i + img.shape[0]]
    # horizontal pass
    pad = np.pad(out, ((0, 0), (rx, rx), (0, 0)), mode="reflect")
    out = np.zeros_like(img)
    for j, w in enumerate(kx):
        out += w * pad[:, j:j + img.shape[1]]
    return out[..., 0] if squeeze else out


# Sobel ksize=5 separable factors (cv2.getDerivKernels(1, 0, 5)):
_SOBEL5_SMOOTH = np.array([1.0, 4.0, 6.0, 4.0, 1.0])
_SOBEL5_DERIV = np.array([-1.0, -2.0, 0.0, 2.0, 1.0])


def sobel5(img: np.ndarray, axis: str) -> np.ndarray:
    """cv2.Sobel(..., dx/dy, ksize=5) equivalent on an HWC float image."""
    if axis == "x":
        return _sep_filter_reflect101(img, kx=_SOBEL5_DERIV, ky=_SOBEL5_SMOOTH)
    if axis == "y":
        return _sep_filter_reflect101(img, kx=_SOBEL5_SMOOTH, ky=_SOBEL5_DERIV)
    raise ValueError(axis)


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (ksize, ksize), sigma) equivalent."""
    k = gaussian_kernel_1d(ksize, sigma)
    # prune numerically-zero tails (a 101-tap kernel at sigma=0.2 — the
    # reference's setting at neural_style_transfer.py:340 — has 3 live taps)
    live = np.nonzero(k > k.max() * 1e-18)[0]
    lo, hi = live[0], live[-1]
    r = max(len(k) // 2 - lo, hi - len(k) // 2)
    k = k[len(k) // 2 - r: len(k) // 2 + r + 1]
    return _sep_filter_reflect101(img, kx=k, ky=k)


# ---------------------------------------------------------------------------
# Reference noise-construction pipeline
# ---------------------------------------------------------------------------


def gaussian_mask(shape: Tuple[int, ...], central_amplitude: float,
                  peripheral_amplitude: float, dispersion_scale: float = 0.5
                  ) -> np.ndarray:
    """Gaussian envelope for one noise level (ref neural_style_transfer.py:396-418)."""
    rows, cols = shape[:2]
    ky = gaussian_kernel_1d(rows, rows * dispersion_scale)
    kx = gaussian_kernel_1d(cols, cols * dispersion_scale)
    kernel = np.outer(ky, kx)
    gauss_norm = kernel / kernel[rows // 2, cols // 2]
    mask = peripheral_amplitude + gauss_norm * (central_amplitude - peripheral_amplitude)
    return np.repeat(mask[:, :, None], 3, axis=2).astype(np.float32)


def make_style_noise(style_img: np.ndarray, targ_shape: Tuple[int, ...],
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Pixel-permutation noise with the style's exact color distribution
    (reference neural_style_transfer.py:422-439)."""
    rng = rng or np.random.default_rng()
    nh, nw = targ_shape[0], targ_shape[1]
    resized = bicubic_resize_np(style_img.astype(np.float32), nh, nw)
    vect = resized.reshape(nh * nw, -1)
    noise_vect = rng.permutation(vect, axis=0)
    return noise_vect.reshape(targ_shape).astype(np.float32)


def build_noise_map(noise_shape: Tuple[int, int, int], style_top: np.ndarray,
                    config: Config, rng: Optional[np.random.Generator] = None,
                    use_normal_noise: bool = False,
                    without_gaussian_mask: bool = False) -> np.ndarray:
    """Multi-level accumulated noise map at the top pyramid resolution
    (reference neural_style_transfer.py:265-313).

    use_normal_noise / without_gaussian_mask mirror the reference's
    demonstration flags (reference neural_style_transfer.py:26-27).
    """
    rng = rng or np.random.default_rng(config.seed)
    nh, nw = noise_shape[0], noise_shape[1]
    noise_img = np.zeros(noise_shape, dtype=np.float32)

    for granularity, central, peripheral, dispersion in zip(
            config.noise_levels, config.noise_levels_central_amplitude,
            config.noise_levels_peripheral_amplitude,
            config.noise_levels_dispersion):
        if granularity == 0:
            # constant brightness layer
            noise_img += gaussian_mask(noise_shape, central, peripheral, dispersion)
            continue
        if granularity > 0:
            # spot count along the shortest axis
            if nh <= nw:
                div_h = granularity
                div_w = nw * granularity // nh
            else:
                div_w = granularity
                div_h = nh * granularity // nw
        else:
            # fixed spot size in pixels
            div_w = nw // (-granularity)
            div_h = nh // (-granularity)

        low_shape = (div_h, div_w, noise_shape[2])
        if use_normal_noise:
            low = np.clip(
                rng.normal(loc=0.0, scale=255.0, size=low_shape).astype(np.float32)
                / 255.0, 0.0, 1.0)
        else:
            low = make_style_noise(style_top, low_shape, rng)

        level_noise = bicubic_resize_np(low, nh, nw)
        if without_gaussian_mask:
            noise_img += level_noise
        else:
            noise_img += level_noise * gaussian_mask(
                level_noise.shape, central, peripheral, dispersion)

    return noise_img


def noise_replacement_map(content_top: np.ndarray, noise_factor: float,
                          ignore_gradient_map: bool = False):
    """Per-pixel noise weight from the blurred Sobel gradient magnitude
    (reference neural_style_transfer.py:325-343)."""
    if ignore_gradient_map:
        return np.float32(noise_factor)
    sx = np.abs(sobel5(content_top, "x"))
    sy = np.abs(sobel5(content_top, "y"))
    mag = np.sqrt(sx * sx + sy * sy)
    mag = np.clip(mag, 0.0, 100.0)
    mag = gaussian_blur(mag, ksize=101, sigma=0.2)
    a = 5.0
    return (a * noise_factor / (a + mag)).astype(np.float32)


def _dump_mask(img: np.ndarray, dump_dir: str, name: str) -> None:
    """SHOW_TEST_IMGS-style debug dump (reference :315-323, :345-347)."""
    from ..utils.image import save_image

    os.makedirs(dump_dir, exist_ok=True)
    save_image(np.clip(img, 0.0, 1.0), os.path.join(dump_dir, name))


def build_init_image(init_method: str, content: np.ndarray, style: np.ndarray,
                     config: Config, rng: Optional[np.random.Generator] = None,
                     use_normal_noise: Optional[bool] = None,
                     without_gaussian_mask: Optional[bool] = None,
                     ignore_gradient_map: Optional[bool] = None
                     ) -> Tuple[np.ndarray, str]:
    """Build the initial optimizing image at top-pyramid resolution.

    Returns (init_img [0,1]-domain HWC float32, init_name).
    Reference neural_style_transfer.py:265-362. The three ablation kwargs
    default to the Config demo flags when not given.
    """
    from .pyramid import resize_to_level

    if use_normal_noise is None:
        use_normal_noise = config.demo_normal_noise
    if without_gaussian_mask is None:
        without_gaussian_mask = config.demo_no_gaussian_mask
    if ignore_gradient_map is None:
        ignore_gradient_map = config.demo_ignore_gradient_map

    rng = rng or np.random.default_rng(config.seed)
    top_level = config.levels_num - 1
    content_top = resize_to_level(content, top_level, config.base_diameter)
    style_top = resize_to_level(style, top_level, config.base_diameter)

    noise_map = build_noise_map(content_top.shape, style_top, config, rng,
                                use_normal_noise=use_normal_noise,
                                without_gaussian_mask=without_gaussian_mask)
    if config.dump_masks_dir:
        _dump_mask(noise_map, config.dump_masks_dir, "noise_mask.jpg")
        _dump_mask(gaussian_blur(noise_map, 107, 0).astype(np.float32),
                   config.dump_masks_dir, "noise_mask_blurry.jpg")

    if init_method == "random":
        return (noise_map * 0.5).astype(np.float32), "random"
    if init_method == "content+noise":
        nr = noise_replacement_map(content_top, config.noise_factor,
                                   ignore_gradient_map)
        if config.dump_masks_dir and not ignore_gradient_map:
            _dump_mask(np.asarray(nr, np.float32), config.dump_masks_dir,
                       "test_noise_rep_blurry.jpg")
        init = ((1.0 - nr) * content_top + nr * noise_map).astype(np.float32)
        return init, "content"
    if init_method == "style":
        # init must share the content image's dimensions (hard constraint,
        # reference neural_style_transfer.py:358-362); the reference resizes
        # the style image to the top level, which only matches when aspect
        # ratios agree — reproduced as-is.
        return style_top.astype(np.float32), "style"
    raise ValueError(f"Unknown init_method: {init_method}")
