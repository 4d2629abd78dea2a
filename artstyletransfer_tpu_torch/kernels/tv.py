"""Total-variation sums: CUDA kernel (csrc/tv.cu) and its plain version.

tv_lane_sums(y) for an NHWC float32 batch y returns the (B, 2) float32
tensor of each image's (sx, sy) = (sum |horizontal neighbour differences|,
sum |vertical neighbour differences|) over its (h, w*c) view: one pair per
lane, from one launch whatever B is. tv_sums(y) is the pair summed over
the whole batch. Replaces the TPU kernel ``_tv_kernel``
(artstyletransfer_tpu/ops/pallas_kernels.py:171), which only takes images
that fit VMEM and is vmapped over the lanes; this one takes any size and
every lane at once. Bound: the images' bytes read once over the memory
rate (memory-bound).
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES
from . import build

_THREADS = 256
_BLOCKS_PER_SM = 4  # enough to fill the card, few partial pairs
_MAX_LANES = 65535  # gridDim.y


def tv_sums_plain(y: torch.Tensor) -> torch.Tensor:
    """(B, 2) float32 per-lane (sx, sy) (the kernel's plain version)."""
    y = y.float()
    sx = (y[:, :, :-1, :] - y[:, :, 1:, :]).abs().sum(dim=(1, 2, 3))
    sy = (y[:, :-1, :, :] - y[:, 1:, :, :]).abs().sum(dim=(1, 2, 3))
    return torch.stack([sx, sy], dim=1)


def _tv_lib():
    fn = build.load("tv").astt_tv_sums
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def tv_sums_cuda(y: torch.Tensor) -> torch.Tensor:
    """The TV kernel on a CUDA tensor (no fallback): (B, 2) float32
    per-lane (sx, sy) on y's device, one launch."""
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
    if b > _MAX_LANES:
        raise ValueError(f"tv: {b} lanes exceed the grid's {_MAX_LANES}")
    sms = torch.cuda.get_device_properties(y.device).multi_processor_count
    blocks = max(1, min(-(-_BLOCKS_PER_SM * sms // b),
                        -(-(h * w * c) // _THREADS)))
    fn = _tv_lib()
    with torch.cuda.device(y.device):
        partial = torch.empty((b, blocks, 2), dtype=torch.float32,
                              device=y.device)
        out = torch.empty((b, 2), dtype=torch.float32, device=y.device)
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), b, h, w, c, blocks, partial.data_ptr(),
                 out.data_ptr(), stream)
    build.check(err, "tv")
    LAUNCHES["tv"] += 1
    return out


def tv_lane_sums(y: torch.Tensor) -> torch.Tensor:
    """(B, 2) per-lane (sx, sy): the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if y.is_cuda:
        return tv_sums_cuda(y)
    if y.device.type == "cpu":
        return tv_sums_plain(y)
    raise ValueError(f"tv: unsupported device {y.device}")


def tv_sums(y: torch.Tensor):
    """(sx, sy) of the whole batch, as 0-d float32 tensors."""
    sx, sy = tv_lane_sums(y).sum(dim=0)
    return sx, sy
