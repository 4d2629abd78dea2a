"""Total-variation sums: CUDA kernel (csrc/tv.cu) and its plain version.

tv_sums(y) for an NHWC float32 batch y returns the float32 pair
(sx, sy) = (sum |horizontal neighbour differences|, sum |vertical
neighbour differences|) over each image's (h, w*c) view. Replaces the TPU
kernel ``_tv_kernel`` (artstyletransfer_tpu/ops/pallas_kernels.py:171),
which only takes images that fit VMEM; this one takes any size. Bound:
the image's bytes read once over the memory rate (memory-bound).
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES
from . import build

_THREADS = 256
_BLOCKS_PER_SM = 4  # enough to fill the card, few partial pairs


def tv_sums_plain(y: torch.Tensor):
    """(sx, sy) as 0-d float32 tensors (the kernel's plain version)."""
    y = y.float()
    sx = (y[:, :, :-1, :] - y[:, :, 1:, :]).abs().sum()
    sy = (y[:, :-1, :, :] - y[:, 1:, :, :]).abs().sum()
    return sx, sy


def _tv_lib():
    fn = build.load("tv").astt_tv_sums
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def tv_sums_cuda(y: torch.Tensor):
    """The TV kernel on a CUDA tensor (no fallback): (sx, sy) as 0-d
    float32 tensors on y's device."""
    if not y.is_cuda:
        raise ValueError(f"tv: expected a CUDA tensor, got {y.device}")
    if y.dtype != torch.float32:
        raise TypeError(f"tv: dtype {y.dtype} not supported (float32)")
    if y.dim() != 4 or min(y.shape) < 1:
        raise ValueError(f"tv: expected a non-empty NHWC batch, got "
                         f"{tuple(y.shape)}")
    if not y.is_contiguous():
        raise ValueError("tv: y must be contiguous NHWC")
    b, h, w, c = y.shape
    if w * c >= 2 ** 31:
        raise ValueError("tv: a row of w*c elements exceeds 32-bit indexing")
    sms = torch.cuda.get_device_properties(y.device).multi_processor_count
    blocks = max(1, min(_BLOCKS_PER_SM * sms, -(-y.numel() // _THREADS)))
    fn = _tv_lib()
    with torch.cuda.device(y.device):
        partial = torch.empty((2 * blocks,), dtype=torch.float32,
                              device=y.device)
        out = torch.empty((2,), dtype=torch.float32, device=y.device)
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), b, h, w, c, blocks, partial.data_ptr(),
                 out.data_ptr(), stream)
    build.check(err, "tv")
    LAUNCHES["tv"] += 1
    return out[0], out[1]


def tv_sums(y: torch.Tensor):
    """(sx, sy): the kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    if y.is_cuda:
        return tv_sums_cuda(y)
    if y.device.type == "cpu":
        return tv_sums_plain(y)
    raise ValueError(f"tv: unsupported device {y.device}")
