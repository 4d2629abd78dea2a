"""Bicubic resize as dense separable matrix products.

The cubic kernel (a = -0.75, half-pixel source centers, replicate border)
matches OpenCV INTER_CUBIC and torch's bicubic interpolate without
antialiasing. A separable resize is ``out = R_h @ img @ R_w^T`` per
channel; the (n_out, n_in) matrices are built once per shape in numpy and
the in-graph resize is two matmuls, exactly (transpose-)differentiable by
autograd. Same matrices as the JAX package, so host pyramids built here
match its bit for bit.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

_A = -0.75  # cubic kernel sharpness used by both OpenCV and torch


def _cubic_kernel(x: np.ndarray, a: float = _A) -> np.ndarray:
    """Keys cubic convolution kernel with sharpness a."""
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    inner = (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0
    outer = a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a
    return np.where(x <= 1.0, inner, np.where(x < 2.0, outer, 0.0))


@lru_cache(maxsize=256)
def _resize_matrix_cached(n_in: int, n_out: int) -> np.ndarray:
    scale = n_in / n_out
    # Half-pixel centers: src = (dst + 0.5) * scale - 0.5
    dst = np.arange(n_out, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    mat = np.zeros((n_out, n_in), dtype=np.float64)
    for tap in (-1, 0, 1, 2):
        w = _cubic_kernel(frac - tap)
        idx = np.clip(base + tap, 0, n_in - 1)  # replicate border
        np.add.at(mat, (dst.astype(np.int64), idx), w)
    mat = mat.astype(np.float32)
    mat.flags.writeable = False  # shared by every caller of the cache
    return mat


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bicubic interpolation matrix (read-only numpy array)."""
    return _resize_matrix_cached(int(n_in), int(n_out))


@lru_cache(maxsize=64)
def _device_matrix(n_in: int, n_out: int, device: str) -> torch.Tensor:
    """resize_matrix as a tensor on `device`, uploaded once per shape (the
    pyramid downscale runs on every loss evaluation). Never mutated."""
    return torch.from_numpy(resize_matrix(n_in, n_out).copy()).to(device)


def bicubic_resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bicubic-resize an NHWC (or HWC) tensor to (out_h, out_w).

    Two matmul passes on img's device, in full float32 at every
    conv_precision: the port never allows TF32 for matmuls (the JAX
    package runs these at the job's precision).
    """
    squeeze = img.dim() == 3
    if squeeze:
        img = img[None]
    _, h, w, _ = img.shape
    if (h, w) == (out_h, out_w):
        return img[0] if squeeze else img
    r_h = _device_matrix(h, out_h, str(img.device))
    r_w = _device_matrix(w, out_w, str(img.device))
    x = img.float()
    # out[b, i, j, c] = sum_{y,x} R_h[i,y] img[b,y,x,c] R_w[j,x]
    out = torch.einsum("iy,byxc->bixc", r_h, x)
    out = torch.einsum("jx,bixc->bijc", r_w, out)
    return out[0] if squeeze else out


def downscale2x(img: torch.Tensor) -> torch.Tensor:
    """Halve an NHWC image (floor division of dims), the reference's
    pyramid step (reference neural_style_transfer.py:173-176)."""
    _, h, w, _ = img.shape
    return bicubic_resize(img, h // 2, w // 2)


def bicubic_resize_np(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Host-side numpy resize for one-time preprocessing (same matrices as
    bicubic_resize; the native 4-tap library when it is built)."""
    squeeze = img.ndim == 3
    if squeeze:
        img = img[None]
    b, h, w, c = img.shape
    if (h, w) != (out_h, out_w):
        from ..native import available as native_available
        from ..native import bicubic_resize as native_resize

        if b == 1 and native_available():
            out = native_resize(np.asarray(img[0], dtype=np.float32),
                                out_h, out_w)
            return out if squeeze else out[None]
        img = img.astype(np.float32)
        r_h = resize_matrix(h, out_h)
        r_w = resize_matrix(w, out_w)
        # (i,y) . (b,y,x,c) -> (i,b,x,c) -> (b,i,x,c)
        img = np.tensordot(r_h, img, axes=([1], [1])).transpose(1, 0, 2, 3)
        # (j,x) . (b,i,x,c) -> (j,b,i,c) -> (b,i,j,c)
        img = np.tensordot(r_w, img, axes=([1], [2])).transpose(1, 2, 0, 3)
    img = np.ascontiguousarray(img, dtype=np.float32)
    return img[0] if squeeze else img
