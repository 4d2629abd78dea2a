"""Fused 3x3 conv + bias + ReLU: CUDA kernel (csrc/conv_relu.cu) and its
plain PyTorch version.

conv_relu(x, w, b) = max(0, conv(x, w, SAME, stride 1) + b) for an NHWC
float32 batch x (N, H, W, Cin), HWIO weights w (3, 3, Cin, Cout) and a
bias b (Cout,); the result is NHWC (N, H, W, Cout) float32. Replaces the
TPU kernel ``_conv_relu_kernel`` (artstyletransfer_tpu/ops/
pallas_kernels.py:267), without its 128-lane channel padding and without
its batch-1 and H % 4 limits (those are VMEM limits; see csrc/conv_relu.cu
for the design).

Two hand-written kernels in one library, picked by shape: an implicit
GEMM on the tensor cores in 3xTF32 where Cin and Cout are multiples of 4
and x and w start on 16-byte boundaries (its 16-byte copies), else the
CUDA-core kernel (Cin = 3, VGG19's first conv, and any other shape). The
tensor-core kernel splits over input channels where its grid would fill
less than a wave of the card (split_plan); the wrapper allocates the
split's workspace with torch.empty. Bound: 2*N*H*W*9*Cin*Cout operations
over the f32 rate (3x that over the TF32 tensor-core rate for the
tensor-core kernel) or (N*H*W*(Cin+Cout) + 9*Cin*Cout)*4 bytes over the
memory rate, whichever is larger (operations at every VGG shape).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import build, launched

_MAX_LANES = 65535  # gridDim.z
# the tensor-core kernel's block: 8 x 16 output pixels x 64 output
# channels, input channels in chunks of 16 (csrc/conv_relu.cu, ConvTile)
_TILE_H, _TILE_W, _TILE_O, _CHUNK = 8, 16, 64, 16


def conv_relu_plain(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: F.conv2d on the channels_last view of x,
    plus the bias, then ReLU; NHWC out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return torch.relu(y + b.view(1, -1, 1, 1)).permute(0, 2, 3, 1)


def _unsupported(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> Optional[str]:
    """Why the CUDA kernel cannot take these tensors, or None."""
    if any(t.dtype != torch.float32 for t in (x, w, b)):
        return "x, w and b must be float32"
    if x.dim() != 4 or x.numel() == 0:
        return f"x must be a non-empty NHWC batch, got {tuple(x.shape)}"
    cin = x.shape[-1]
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin) or w.shape[3] < 1:
        return f"w must be (3, 3, {cin}, Cout) HWIO, got {tuple(w.shape)}"
    if tuple(b.shape) != (w.shape[3],):
        return f"b must be ({w.shape[3]},), got {tuple(b.shape)}"
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        return "x (NHWC), w (HWIO) and b must be contiguous"
    n, h, wd, _ = x.shape
    if max(x.numel(), n * h * wd * w.shape[3], w.numel()) >= 2 ** 31:
        return "a tensor of 2^31 elements or more exceeds 32-bit indexing"
    if n > _MAX_LANES:
        return f"{n} images exceed the grid's {_MAX_LANES}"
    return None


def conv_relu_supported(x: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor) -> bool:
    """Whether conv_relu_cuda takes these tensors (one of its two kernels):
    float32, NHWC x, HWIO w, contiguous, and every tensor under 2^31
    elements. Any Cin, Cout, batch and image size."""
    return _unsupported(x, w, b) is None


def uses_tensor_cores(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether conv_relu_cuda runs the tensor-core kernel for these
    tensors (else the CUDA-core kernel): Cin and Cout multiples of 4, x and
    w on 16-byte boundaries."""
    return (x.shape[-1] % 4 == 0 and w.shape[-1] % 4 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def split_plan(n: int, h: int, w: int, cin: int, cout: int, sms: int):
    """(splits, chunks_per_split) of the tensor-core kernel's split over
    input channels: none (one split of every chunk) where the blocks of
    the n images' pixel tiles x output-channel blocks fill a wave of the
    card's `sms` SMs, else enough splits of whole 16-channel chunks, every
    split non-empty, that the grid does (as far as the chunks allow)."""
    tiles = (-(-h // _TILE_H) * -(-w // _TILE_W) * -(-cout // _TILE_O)
             * n)
    chunks = -(-cin // _CHUNK)
    if tiles >= sms:
        return 1, chunks
    per = max(1, chunks // -(-sms // tiles))
    return -(-chunks // per), per


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # x, w, b, n, h, w, cin, cout, y, stream
    "astt_conv3x3_relu": [_P] * 3 + [_I] * 5 + [_P] * 2,
    # x, w, b, n, h, w, cin, cout, splits, chunks_per_split, part, y, stream
    "astt_conv3x3_relu_tc": [_P] * 3 + [_I] * 7 + [_P] * 3,
}


def _entry(name: str):
    fn = getattr(build.load("conv_relu"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def conv_relu_cuda(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """The fused kernel on CUDA tensors (no fallback)."""
    if not (x.is_cuda and w.device == x.device and b.device == x.device):
        raise ValueError(f"conv_relu: x, w and b must be CUDA tensors on one "
                         f"device, got {x.device}, {w.device}, {b.device}")
    why = _unsupported(x, w, b)
    if why is not None:
        raise ValueError(f"conv_relu: {why}")
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    with torch.cuda.device(x.device):
        out = torch.empty((n, h, wd, cout), dtype=torch.float32,
                          device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if uses_tensor_cores(x, w):
            sms = torch.cuda.get_device_properties(
                x.device).multi_processor_count
            splits, per = split_plan(n, h, wd, cin, cout, sms)
            part = (torch.empty((splits, n, h, wd, cout),
                                dtype=torch.float32, device=x.device)
                    if splits > 1 else None)
            err = _entry("astt_conv3x3_relu_tc")(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), n, h, wd, cin,
                cout, splits, per, None if part is None else part.data_ptr(),
                out.data_ptr(), stream)
        else:
            err = _entry("astt_conv3x3_relu")(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), n, h, wd, cin,
                cout, out.data_ptr(), stream)
    build.check(err, "conv_relu")
    launched("conv_relu", stream, x.device.index)
    return out


def conv_relu(x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.is_cuda:
        return conv_relu_cuda(x, w, b)
    if x.device.type == "cpu":
        return conv_relu_plain(x, w, b)
    raise ValueError(f"conv_relu: unsupported device {x.device}")
