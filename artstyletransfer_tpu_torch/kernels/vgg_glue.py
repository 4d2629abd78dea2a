"""VGG19's element-wise work between its cuDNN convolutions, one pass each
way per convolution: the CUDA kernels (csrc/vgg_glue.cu) and their plain
PyTorch versions.

Every tensor is (B, C, H, W) in channels_last memory, float32 or
bfloat16, as models/vgg19.py's convolutions leave them; C is a multiple
of 16 bytes' worth of elements (4 float32, 8 bfloat16).

- glue(y, bias, pool=..., keep_pre=..., keep_post=...) -> (pre, out,
  code): over a convolution's output y, pre = y + bias (rounded to y's
  dtype; bias None: pre is y) and post = relu(pre). A pool layer's out is
  F.max_pool2d(post, 2, 2) and code one uint8 per pooled value, the
  maximum's position in its 2x2 window (0..3, row-major) | 4 where it is
  > 0; the full-size post is not made. Otherwise out is post (None with
  keep_post False) and code None. pre is None unless keep_pre; the kernel
  writes it over y. Bound: bytes, 8 per element of y in float32 (12 with
  pre), 5.25 on a pool layer.
- glue_bwd(g, post=..., tap=..., tap_after=...) or glue_bwd(g, code=...,
  size=...) -> the gradient at y (= at pre), with mask(a) = where(post <=
  0, 0, a), threshold_backward's rule: mask(g + tap) for a tap of post,
  mask(g) + tap for a tap of pre (tap_after), mask(g) without a tap; g
  None (the last layer): mask(tap), a tap of post. On a pool layer g is
  the pooled map's gradient, and each value goes to the window position
  its code names, as 0 + g, where the code says > 0; every other position
  of y's (h, w) = size, an odd dropped row or column too, gets 0. Bound:
  bytes, 12 per element of y in float32 (16 with a tap), 5.25 on a pool
  layer.

The arithmetic is PyTorch's per-op path's (the bias add, clamp_min,
max_pool2d, threshold_backward, the pool's backward and autograd's add),
so both versions give that path's bits.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build, launched

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256
_BLOCKS_PER_SM = 8  # 2048 resident threads an SM in blocks of 256
_CL = torch.channels_last


def _cl_empty(shape, like, dtype=None):
    return torch.empty(shape, dtype=dtype or like.dtype, device=like.device,
                       memory_format=_CL)


def glue_plain(y: torch.Tensor, bias, pool: bool = False,
               keep_pre: bool = False, keep_post: bool = True):
    """The forward's plain version (the per-op path): (pre, out, code)."""
    pre = y if bias is None else y + bias.view(1, -1, 1, 1)
    if not (pool or keep_post):
        return pre if keep_pre else None, None, None
    post = F.relu(pre)
    if not pool:
        return pre if keep_pre else None, post, None
    out, idx = F.max_pool2d(post, 2, 2, return_indices=True)
    w = post.shape[3]
    pos = (idx // w % 2) * 2 + idx % w % 2
    code = (pos + 4 * (out > 0)).to(torch.uint8)
    return pre if keep_pre else None, out, code


def glue_bwd_plain(g, post=None, tap=None, tap_after: bool = False,
                   code=None, size=None):
    """The backward's plain version (the per-op path's ops)."""
    if code is not None:
        h, w = size
        b, c, ho, wo = g.shape
        out = _cl_empty((b, c, h, w), g).zero_()
        g0 = torch.zeros_like(g) + g  # the pool's backward: 0 + g
        zero = torch.zeros((), dtype=g.dtype)
        for q in range(4):
            out[:, :, q // 2:2 * ho:2, q % 2:2 * wo:2] = torch.where(
                code == 4 + q, g0, zero)
        return out
    if tap is not None and not tap_after:
        g = tap if g is None else g + tap
    g = torch.where(post <= 0, torch.zeros((), dtype=g.dtype), g)
    if tap is not None and tap_after:
        g = g + tap
    return g


def _check(t, what, name, like=None):
    if not t.is_cuda:
        raise ValueError(f"{what}: {name} must be a CUDA tensor, got "
                         f"{t.device}")
    if t.dtype not in _DTYPE_CODE and t.dtype != torch.uint8:
        raise TypeError(f"{what}: {name} dtype {t.dtype} not supported "
                        "(float32 or bfloat16)")
    if t.dim() != 4 or not t.is_contiguous(memory_format=_CL):
        raise ValueError(f"{what}: {name} must be a (B, C, H, W) "
                         f"channels_last tensor, got {tuple(t.shape)} "
                         f"strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must start on a 16-byte boundary")
    if like is not None and (t.device != like.device
                             or (t.dtype != torch.uint8
                                 and t.dtype != like.dtype)):
        raise ValueError(f"{what}: {name} must be {like.dtype} on "
                         f"{like.device}")


def _channels(t, what):
    c = t.shape[1]
    per = 16 // t.element_size()
    if c % per or c // per > _THREADS:
        raise ValueError(f"{what}: C = {c} must be a multiple of {per} and "
                         f"at most {per * _THREADS}")
    return c


def _max_blocks(t):
    return (torch.cuda.get_device_properties(t.device).multi_processor_count
            * _BLOCKS_PER_SM)


_P, _I = ctypes.c_void_p, ctypes.c_int
_HEADS = {
    # y, bias, dtype, pool, write_pre, out, code
    "astt_vgg_glue_fwd": [_P, _P, _I, _I, _I, _P, _P],
    # g, post, code, t, dtype, pool, tap_after, out
    "astt_vgg_glue_bwd": [_P, _P, _P, _P, _I, _I, _I, _P],
}


def _lib(name):
    fn = getattr(build.load("vgg_glue"), name)
    if fn.argtypes is None:
        # ... lanes, h, w, c, max_blocks, stream
        fn.argtypes = _HEADS[name] + [_I] * 5 + [_P]
        fn.restype = ctypes.c_int
    return fn


def glue_cuda(y: torch.Tensor, bias, pool: bool = False,
              keep_pre: bool = False, keep_post: bool = True):
    """The forward kernel on CUDA tensors (no fallback), one launch."""
    _check(y, "vgg_glue", "y")
    c = _channels(y, "vgg_glue")
    b, _, h, w = y.shape
    if bias is not None:
        if (not bias.is_cuda or bias.device != y.device
                or bias.dtype != y.dtype or tuple(bias.shape) != (c,)
                or not bias.is_contiguous() or bias.data_ptr() % 16):
            raise ValueError(f"vgg_glue: bias must be a contiguous ({c},) "
                             f"{y.dtype} tensor on {y.device}, 16-byte "
                             "aligned")
    if pool and (h < 2 or w < 2):
        raise ValueError(f"vgg_glue: a 2x2 pool of a {h}x{w} map")
    if pool and keep_pre:
        raise ValueError("vgg_glue: a pool layer keeps no pre")
    if not (pool or keep_post or keep_pre):
        raise ValueError("vgg_glue: nothing to write")
    with torch.cuda.device(y.device):
        code = None
        if pool:
            out = _cl_empty((b, c, h // 2, w // 2), y)
            code = _cl_empty((b, c, h // 2, w // 2), y, torch.uint8)
        else:
            out = _cl_empty(y.shape, y) if keep_post else None
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = _lib("astt_vgg_glue_fwd")(
            y.data_ptr(), None if bias is None else bias.data_ptr(),
            _DTYPE_CODE[y.dtype], int(pool), int(keep_pre),
            None if out is None else out.data_ptr(),
            None if code is None else code.data_ptr(), b, h, w, c,
            _max_blocks(y), stream)
    build.check(err, "vgg_glue")
    launched("vgg_glue", stream, y.device.index)
    return y if keep_pre else None, out, code


def glue_bwd_cuda(g, post=None, tap=None, tap_after: bool = False,
                  code=None, size=None):
    """The backward kernel on CUDA tensors (no fallback), one launch."""
    ref = g if g is not None else tap
    if ref is None:
        raise ValueError("vgg_glue_bwd: no gradient")
    _check(ref, "vgg_glue_bwd", "g")
    c = _channels(ref, "vgg_glue_bwd")
    b = ref.shape[0]
    if code is not None:
        if g is None or tap is not None:
            raise ValueError("vgg_glue_bwd: a pool layer takes g and no tap")
        _check(code, "vgg_glue_bwd", "code", g)
        if code.dtype != torch.uint8 or code.shape != g.shape:
            raise ValueError("vgg_glue_bwd: code must be uint8 of g's shape")
        h, w = size
        if h // 2 != g.shape[2] or w // 2 != g.shape[3]:
            raise ValueError(f"vgg_glue_bwd: a {tuple(g.shape[2:])} pooled "
                             f"map is not the pool of {h}x{w}")
    else:
        if g is None and (tap is None or tap_after):
            raise ValueError("vgg_glue_bwd: without g, the tap's gradient "
                             "of post alone")
        h, w = ref.shape[2:]
        for name, t in (("g", g), ("post", post), ("tap", tap)):
            if t is not None:
                _check(t, "vgg_glue_bwd", name, ref)
                if t.shape != ref.shape:
                    raise ValueError(f"vgg_glue_bwd: {name} shape "
                                     f"{tuple(t.shape)}, expected "
                                     f"{tuple(ref.shape)}")
        if post is None:
            raise ValueError("vgg_glue_bwd: post is needed for the mask")
    with torch.cuda.device(ref.device):
        out = _cl_empty((b, c, h, w), ref)
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        ptr = (lambda t: None if t is None else t.data_ptr())
        err = _lib("astt_vgg_glue_bwd")(
            ptr(g), ptr(post), ptr(code), ptr(tap), _DTYPE_CODE[ref.dtype],
            int(code is not None), int(tap_after), out.data_ptr(), b, h, w,
            c, _max_blocks(ref), stream)
    build.check(err, "vgg_glue_bwd")
    launched("vgg_glue_bwd", stream, ref.device.index)
    return out


def glue(y: torch.Tensor, bias, pool: bool = False, keep_pre: bool = False,
         keep_post: bool = True):
    """The forward: the kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    if y.is_cuda:
        return glue_cuda(y, bias, pool, keep_pre, keep_post)
    if y.device.type == "cpu":
        return glue_plain(y, bias, pool, keep_pre, keep_post)
    raise ValueError(f"vgg_glue: unsupported device {y.device}")


def glue_bwd(g, post=None, tap=None, tap_after: bool = False, code=None,
             size=None):
    """The backward: the kernel for CUDA tensors, the plain version on the
    CPU."""
    ref = g if g is not None else tap
    if ref.is_cuda:
        return glue_bwd_cuda(g, post, tap, tap_after, code, size)
    if ref.device.type == "cpu":
        return glue_bwd_plain(g, post, tap, tap_after, code, size)
    raise ValueError(f"vgg_glue_bwd: unsupported device {ref.device}")
