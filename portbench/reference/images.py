"""Plain NumPy copies of the port's host-side image pipeline.

Frozen copies of what a job derives from its two raw images before the
first evaluation: the ImageNet preprocessing, the bicubic resize matrices
(a = -0.75, half-pixel centers, replicate border), the pyramid levels'
shapes and images, and the 'content+noise' initial image with its
Gaussian envelopes, Sobel-driven noise weight and pixel-permutation noise
(the reference repository's neural_style_transfer.py:265-362). Nothing
here imports the port: the benchmark judges the port by these.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

IMAGENET_MEAN_255 = np.array([123.675, 116.28, 103.53], dtype=np.float32)


def prepare(img: np.ndarray) -> np.ndarray:
    """[0, 1] RGB HWC -> the (1, h, w, 3) network input, x*255 - mean."""
    return (img.astype(np.float32) * 255.0 - IMAGENET_MEAN_255)[None]


def unprepare(x: np.ndarray) -> np.ndarray:
    """The network input back to [0, 1] RGB HWC, unclipped."""
    arr = np.asarray(x, np.float32)
    return ((arr[0] if arr.ndim == 4 else arr) + IMAGENET_MEAN_255) / 255.0


def _cubic(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    x = np.abs(x)
    x2, x3 = x * x, x * x * x
    inner = (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0
    outer = a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a
    return np.where(x <= 1.0, inner, np.where(x < 2.0, outer, 0.0))


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 bicubic interpolation matrix."""
    dst = np.arange(n_out, dtype=np.float64)
    src = (dst + 0.5) * (n_in / n_out) - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    mat = np.zeros((n_out, n_in), dtype=np.float64)
    for tap in (-1, 0, 1, 2):
        idx = np.clip(base + tap, 0, n_in - 1)
        np.add.at(mat, (dst.astype(np.int64), idx), _cubic(frac - tap))
    return mat.astype(np.float32)


def resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bicubic resize of an HWC float image by the two matrices."""
    h, w = img.shape[:2]
    img = img.astype(np.float32)
    if (h, w) == (out_h, out_w):
        return img
    out = np.tensordot(resize_matrix(h, out_h), img, axes=([1], [0]))
    out = np.tensordot(resize_matrix(w, out_w), out, axes=([1], [1]))
    return np.ascontiguousarray(out.transpose(1, 0, 2), np.float32)


def level_shape(h: int, w: int, level: int, base: int) -> Tuple[int, int]:
    """(h, w) of a pyramid level: shortest side base * 2^level."""
    if h >= w:
        bw, bh = base, int(base * (h / w))
    else:
        bh, bw = base, int(base * (w / h))
    return bh * 2 ** level, bw * 2 ** level


def to_level(img: np.ndarray, level: int, base: int) -> np.ndarray:
    return resize(img, *level_shape(img.shape[0], img.shape[1], level, base))


def pyramids(content: np.ndarray, style: np.ndarray, levels: int,
             base: int):
    """(content levels, style levels), highest resolution first."""
    order = range(levels - 1, -1, -1)
    return ([to_level(content, lvl, base) for lvl in order],
            [to_level(style, lvl, base) for lvl in order])


# -- the initial image ------------------------------------------------------


def _gauss1d(n: int, sigma: float) -> np.ndarray:
    if sigma <= 0:
        sigma = 0.3 * ((n - 1) * 0.5 - 1) + 0.8
    x = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def _filter(img: np.ndarray, kx: np.ndarray, ky: np.ndarray) -> np.ndarray:
    """Separable correlation with mirrored (reflect-101) borders."""
    img = np.asarray(img, np.float64)
    ry, rx = len(ky) // 2, len(kx) // 2
    pad = np.pad(img, ((ry, ry), (0, 0), (0, 0)), mode="reflect")
    out = sum(wt * pad[i:i + img.shape[0]] for i, wt in enumerate(ky))
    pad = np.pad(out, ((0, 0), (rx, rx), (0, 0)), mode="reflect")
    return sum(wt * pad[:, j:j + img.shape[1]] for j, wt in enumerate(kx))


def _blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    k = _gauss1d(ksize, sigma)
    live = np.nonzero(k > k.max() * 1e-18)[0]
    r = max(len(k) // 2 - live[0], live[-1] - len(k) // 2)
    k = k[len(k) // 2 - r: len(k) // 2 + r + 1]
    return _filter(img, k, k)


def _mask(shape, central: float, peripheral: float,
          dispersion: float) -> np.ndarray:
    rows, cols = shape[:2]
    kernel = np.outer(_gauss1d(rows, rows * dispersion),
                      _gauss1d(cols, cols * dispersion))
    norm = kernel / kernel[rows // 2, cols // 2]
    mask = peripheral + norm * (central - peripheral)
    return np.repeat(mask[:, :, None], 3, axis=2).astype(np.float32)


def _noise_map(shape, style_top: np.ndarray, cfg: dict,
               rng: np.random.Generator) -> np.ndarray:
    nh, nw = shape[:2]
    out = np.zeros(shape, np.float32)
    for gran, central, peri, disp in zip(
            cfg["noise_levels"], cfg["noise_levels_central_amplitude"],
            cfg["noise_levels_peripheral_amplitude"],
            cfg["noise_levels_dispersion"]):
        if gran == 0:
            out += _mask(shape, central, peri, disp)
            continue
        if gran > 0:
            div_h, div_w = ((gran, nw * gran // nh) if nh <= nw
                            else (nh * gran // nw, gran))
        else:
            div_w, div_h = nw // (-gran), nh // (-gran)
        small = resize(style_top, div_h, div_w).reshape(div_h * div_w, -1)
        low = rng.permutation(small, axis=0).reshape(div_h, div_w, 3)
        level = resize(low.astype(np.float32), nh, nw)
        out += level * _mask(level.shape, central, peri, disp)
    return out


_SOBEL_SMOOTH = np.array([1.0, 4.0, 6.0, 4.0, 1.0])
_SOBEL_DERIV = np.array([-1.0, -2.0, 0.0, 2.0, 1.0])


def init_image(content: np.ndarray, style: np.ndarray, cfg: dict,
               noise_seed: int) -> np.ndarray:
    """The 'content+noise' initial image at the top level, [0, 1] HWC."""
    if cfg["init_method"] != "content+noise":
        raise ValueError("the reference builds the content+noise init only")
    rng = np.random.default_rng(noise_seed)
    top = cfg["levels_num"] - 1
    c_top = to_level(content, top, cfg["base_diameter"])
    s_top = to_level(style, top, cfg["base_diameter"])
    noise = _noise_map(c_top.shape, s_top, cfg, rng)
    sx = np.abs(_filter(c_top, _SOBEL_DERIV, _SOBEL_SMOOTH))
    sy = np.abs(_filter(c_top, _SOBEL_SMOOTH, _SOBEL_DERIV))
    mag = _blur(np.clip(np.sqrt(sx * sx + sy * sy), 0.0, 100.0), 101, 0.2)
    nr = (5.0 * cfg["noise_factor"] / (5.0 + mag)).astype(np.float32)
    return ((1.0 - nr) * c_top + nr * noise).astype(np.float32)


def check_canonical(content: np.ndarray, style: np.ndarray,
                    cfg: dict) -> None:
    """The serving path crops contents to an aspect bucket and resizes
    styles to a base-diameter square. The benchmark sends images that are
    already canonical (a square content of the top level's side, a square
    style of the base diameter), for which both steps are the identity;
    raise on any other image, which this reference does not canonicalize."""
    side = cfg["base_diameter"] * 2 ** (cfg["levels_num"] - 1)
    base = cfg["base_diameter"]
    if content.shape[:2] != (side, side) or style.shape[:2] != (base, base):
        raise ValueError(f"non-canonical shapes {content.shape[:2]} / "
                         f"{style.shape[:2]}: expected ({side}, {side}) and "
                         f"({base}, {base})")
