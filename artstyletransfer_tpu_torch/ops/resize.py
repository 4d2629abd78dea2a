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

from .blocks import halos, on_block

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


@lru_cache(maxsize=256)
def _block_rows(h: int, n_space: int, k: int, device: str):
    """(first input row, the (h/(2 S), rows read) block of the downscale
    matrix) of block k of an h-row image over n_space blocks: the rows of
    resize_matrix(h, h/2) for the block's own output rows, and the
    columns from one row above its input block to one row below it
    (clipped at the image's first and last rows, where the replicate
    border is already in the matrix). Every other column of those rows is
    0, so the block form is exact row by row."""
    hk = h // n_space
    o0, o1 = k * hk // 2, (k + 1) * hk // 2
    a, z = max(k * hk - 1, 0), min((k + 1) * hk + 1, h)
    rows = resize_matrix(h, h // 2)[o0:o1]
    if np.count_nonzero(rows[:, :a]) or np.count_nonzero(rows[:, z:]):
        raise ValueError(f"block {k} of {n_space} of {h} rows reads past "
                         "its halos")
    return a, torch.from_numpy(rows[:, a:z].copy()).to(device)


class DownscaleBlocksFn(torch.autograd.Function):
    """downscale2x of an NHWC image held as its row blocks: apply(*blocks)
    (parallel/space.py: equal heights, block k on its own device, each a
    multiple of 2 rows). Forward: block k's output rows from its own rows
    and one halo row from each neighbour (_block_rows), then the width
    pass, in float32 as bicubic_resize. Backward: the transposed products,
    and each halo row's gradient added to the row it came from, in block
    order (one node for every block, as models/vgg19.py's HaloConvFn)."""

    @staticmethod
    def forward(ctx, *blocks):
        n = len(blocks)
        _, hk, w, _ = blocks[0].shape
        ctx.mats, out = [], []
        for k, (b, (up, dn)) in enumerate(zip(blocks, halos(blocks, 1))):
            with on_block(k):
                r_h = _block_rows(hk * n, n, k, str(b.device))[1]
                r_w = _device_matrix(w, w // 2, str(b.device))
                x = torch.cat([t for t in (up, b, dn) if t is not None],
                              dim=1).float()
                o = torch.einsum("iy,byxc->bixc", r_h, x)
                out.append(torch.einsum("jx,bixc->bijc", r_w, o))
                ctx.mats.append((r_h, r_w))
        return tuple(out)

    @staticmethod
    def backward(ctx, *gouts):
        exts = [torch.einsum("iy,bixc->byxc", r_h,
                             torch.einsum("jx,bijc->bixc", r_w, g))
                for g, (r_h, r_w) in zip(gouts, ctx.mats)]
        n = len(exts)
        grads = [e[:, int(k > 0):e.shape[1] - int(k + 1 < n)]
                 for k, e in enumerate(exts)]
        for k, e in enumerate(exts):
            if k > 0:
                grads[k - 1][:, -1:] += e[:, :1].to(grads[k - 1].device)
            if k + 1 < n:
                grads[k + 1][:, :1] += e[:, -1:].to(grads[k + 1].device)
        return tuple(grads)


def downscale2x_blocks(blocks):
    """downscale2x of an NHWC image held as its row blocks: block k of the
    result holds the output rows of block k (DownscaleBlocksFn)."""
    return list(DownscaleBlocksFn.apply(*blocks))


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
