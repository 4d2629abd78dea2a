"""Gram forward and backward: CUDA kernels (csrc/gram.cu, csrc/gram_bwd.cu)
and their plain PyTorch versions.

Both take F, the (n, c) row-major feature matrix of one NHWC tap
(n = h*w), in float32 or bfloat16, or a (B, n, c) stack of them, one per
lane of a batch; a stack runs as one launch whatever B is, and the
results carry the same leading axis:

- gram(f, scale) = scale * F^T F, (c, c) float32, c a multiple of 8.
  Replaces the TPU kernel ``_gram_kernel``
  (artstyletransfer_tpu/ops/pallas_kernels.py:52). It runs on the tensor
  cores in 3xTF32 (see csrc/gram.cu). Bound: the larger of F's bytes over
  the memory rate and 3 * n*c*(c+1) TF32 operations (G is symmetric: only
  its upper triangle is computed) over the tensor-core rate (n*c*(c+1)
  FLOPs over the f32 rate on CUDA cores).
- gram_bwd(f, g) = F @ g with g (c, c) float32, in F's dtype, c a
  multiple of 8. Replaces ``_gram_bwd_kernel`` (pallas_kernels.py:107).
  It runs on the tensor cores in 3xTF32 (see csrc/gram_bwd.cu). Bound: the
  larger of the bytes of F read and dF written and 3 * 2*n*c^2 TF32
  operations over the tensor-core rate (2*n*c^2 FLOPs over the f32 rate
  on CUDA cores).

The forward is split over rows (see csrc/gram.cu); the wrapper picks the
split from the card's SM count and the number of lanes (split_plan), and
allocates the (B, splits, c, c) workspace with torch.empty.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, launched

# the forward's 64 x 64 output tiles of G, walked in 32-row chunks
# (csrc/gram.cu); row splits: at most _BLOCKS_PER_SM blocks per SM in all
# (three waves of three resident blocks), at least _MIN_ROWS rows and at
# most _MAX_SPLITS splits (what the second pass sums quickly)
_TILE, _CHUNK = 64, 32
_BLOCKS_PER_SM = 9
_MIN_ROWS = 128
_MAX_SPLITS = 256
_MAX_LANES = 65535  # gridDim.z
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def gram_plain(f: torch.Tensor, scale: float) -> torch.Tensor:
    """scale * F^T F in float32 (the kernel's plain version), one matrix
    product per lane: on an H100 a batched product (torch.bmm) of 2 or
    more lanes of long F sums far less accurately than the same products
    lane by lane (relative error 1.3e-3 against 7e-7 to the float64 Gram
    at 4 lanes of a 2048 px relu1_1 tap, n = 4,194,304; chip_smoke.py's
    2048 px rows)."""
    f32 = f.float()
    if f32.dim() == 2:
        return (f32.T @ f32) * scale
    return torch.stack([(lane.T @ lane) * scale for lane in f32])


def gram_bwd_plain(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """F @ g in float32, cast to F's dtype (the kernel's plain version)."""
    return (f.float() @ g.float()).to(f.dtype)


def _check_features(f: torch.Tensor, what: str) -> None:
    if not f.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {f.device}")
    if f.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: dtype {f.dtype} not supported "
                        "(float32 or bfloat16)")
    if f.dim() not in (2, 3) or f.numel() == 0:
        raise ValueError(f"{what}: expected a non-empty (n, c) matrix or "
                         f"(B, n, c) stack, got {tuple(f.shape)}")
    if not f.is_contiguous():
        raise ValueError(f"{what}: F must be contiguous (row-major)")
    if f.shape[-2] * f.shape[-1] >= 2 ** 31:
        raise ValueError(f"{what}: {f.shape[-2] * f.shape[-1]} elements per "
                         "lane exceed the kernel's 32-bit row index")
    if f.dim() == 3 and f.shape[0] > _MAX_LANES:
        raise ValueError(f"{what}: {f.shape[0]} lanes exceed the grid's "
                         f"{_MAX_LANES}")


def _lanes(f: torch.Tensor):
    """(B, n, c) view of a matrix or a stack of them."""
    return f if f.dim() == 3 else f.unsqueeze(0)


def split_plan(n: int, c: int, sms: int, batch: int = 1):
    """(splits, rows_per_split) of the forward's row split: at most
    _BLOCKS_PER_SM blocks per SM of the card over all `batch` lanes, at
    least _MIN_ROWS rows and whole 32-row chunks per split, at most
    _MAX_SPLITS splits."""
    n_tiles = -(-c // _TILE)
    tiles = n_tiles * (n_tiles + 1) // 2 * batch
    splits = max(1, min(_BLOCKS_PER_SM * sms // tiles, n // _MIN_ROWS,
                        _MAX_SPLITS))
    rows = -(-n // splits)
    rows = -(-rows // _CHUNK) * _CHUNK
    return -(-n // rows), rows


def _gram_lib():
    lib = build.load("gram")
    fn = lib.astt_gram
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _gram_bwd_lib():
    lib = build.load("gram_bwd")
    fn = lib.astt_gram_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def gram_cuda(f: torch.Tensor, scale: float) -> torch.Tensor:
    """The Gram forward kernel on a CUDA tensor (no fallback): (c, c) for
    an (n, c) matrix, (B, c, c) for a (B, n, c) stack, one launch."""
    _check_features(f, "gram")
    batch, n, c = _lanes(f).shape
    if c % 8:
        raise ValueError(f"gram: c = {c} is not a multiple of 8 (the kernel "
                         "copies 16-byte row pieces)")
    if f.data_ptr() % 16:
        raise ValueError("gram: F must start on a 16-byte boundary")
    sms = torch.cuda.get_device_properties(f.device).multi_processor_count
    splits, rows = split_plan(n, c, sms, batch)
    fn = _gram_lib()
    with torch.cuda.device(f.device):
        part = torch.empty((batch, splits, c, c), dtype=torch.float32,
                           device=f.device)
        out = torch.empty(f.shape[:-2] + (c, c), dtype=torch.float32,
                          device=f.device)
        stream = torch.cuda.current_stream(f.device).cuda_stream
        err = fn(f.data_ptr(), _DTYPE_CODE[f.dtype], batch, n, c, splits,
                 rows, float(scale), part.data_ptr(), out.data_ptr(), stream)
    build.check(err, "gram")
    launched("gram", stream, f.device.index)
    return out


def gram_bwd_cuda(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The Gram backward kernel on CUDA tensors (no fallback): F (n, c)
    with g (c, c), or F (B, n, c) with g (B, c, c), one launch."""
    _check_features(f, "gram_bwd")
    batch, n, c = _lanes(f).shape
    if c % 8:
        raise ValueError(f"gram_bwd: c = {c} is not a multiple of 8 (the "
                         "kernel copies 16-byte row pieces)")
    want = f.shape[:-2] + (c, c)
    if (not g.is_cuda or g.device != f.device or g.dtype != torch.float32
            or tuple(g.shape) != want or not g.is_contiguous()):
        raise ValueError(f"gram_bwd: g must be a contiguous {want} "
                         f"float32 tensor on {f.device}")
    if f.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("gram_bwd: F and g must start on 16-byte "
                         "boundaries")
    fn = _gram_bwd_lib()
    with torch.cuda.device(f.device):
        out = torch.empty(f.shape, dtype=f.dtype, device=f.device)
        stream = torch.cuda.current_stream(f.device).cuda_stream
        err = fn(f.data_ptr(), _DTYPE_CODE[f.dtype], g.data_ptr(), batch, n,
                 c, out.data_ptr(), stream)
    build.check(err, "gram_bwd")
    launched("gram_bwd", stream, f.device.index)
    return out


def gram(f: torch.Tensor, scale: float) -> torch.Tensor:
    """scale * F^T F: the kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    if f.is_cuda:
        return gram_cuda(f, scale)
    if f.device.type == "cpu":
        return gram_plain(f, scale)
    raise ValueError(f"gram: unsupported device {f.device}")


def gram_bwd(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """F @ g: the kernel for CUDA tensors, the plain version on the CPU."""
    if f.is_cuda:
        return gram_bwd_cuda(f, g)
    if f.device.type == "cpu":
        return gram_bwd_plain(f, g)
    raise ValueError(f"gram_bwd: unsupported device {f.device}")

