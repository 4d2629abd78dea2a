"""Squared-mean total variation: CUDA kernels (csrc/tv.cu) and their plain
versions, forward and backward, per lane of an NHWC float32 batch.

- tv(y) -> (tv (B,), means (B, 2)): each lane's (mean |dx|, mean |dy|)
  over its (h, w*c) view (horizontal neighbours c apart, vertical ones a
  row apart) and tv = mean_x^2 + mean_y^2. Replaces the TPU kernel
  ``_tv_kernel`` (artstyletransfer_tpu/ops/pallas_kernels.py:171) with
  ``_tv_means`` and the squares of ``_tv_impl`` around it, vmapped over
  the lanes: one launch for every lane, one thread block cluster per lane.
  Bound: the images' bytes read once over the memory rate.
- tv_bwd(y, g, means) -> grad (B, h, w, c): the gradient of sum_b g[b]
  tv[b], sign(0) = 0 (``_tv_vjp_bwd`` with ``_dx_part``/``_dy_part``,
  pallas_kernels.py:222, which is XLA in the JAX package): one launch for
  every lane. Bound: the images' bytes read once and written once.

A seam (parallel/space.py: one image's rows over several devices, each
call one block of rows): both take h_total, the image's height for the
means' denominators, and an optional halo, the next block's first row
(B, w*c). tv(y, h_total, halo) returns each lane's partial means, the
vertical sum including the pair (last row, halo), which add up over the
blocks to the image's means; tv_bwd(y, g, means, h_total, halo), given
the image's means, returns the block's gradient (the seam pair's part on
its last row) and the halo row's gradient, which goes back to the next
block's first row. Without them both are the whole-image functions, bit
for bit.

Each runs its kernel for a CUDA tensor, its plain version for a CPU tensor,
and raises for anything else. The launch plan (launch_plan) is a plain
function of the shape, the card's SM count and how many clusters of 16
blocks it holds at once, both read once per device.
tv_lane_sums / tv_sums give the (B, 2) sums and the whole batch's pair.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build, launched

_MAX_LANES = 65535        # gridDim.y
_MAX_C = 4                # channels the kernels are built for (1..4)
_WARP = 32
_FWD_MAX_WARPS = 32       # forward blocks of up to 1024 threads
_FWD_MIN_ROWS = 8         # rows per warp strip before blocks grow
_BWD_WARPS = 8            # backward blocks of 256 threads
_BWD_WARPS_PER_SM = 16    # the backward's target, over the whole batch
_BWD_ROWS = (4, 32)       # its rows per warp strip, least and most


def _with_halo(y: torch.Tensor, halo) -> torch.Tensor:
    """y's rows, then the halo row (B, w*c) when one is given."""
    if halo is None:
        return y
    b, _, w, c = y.shape
    return torch.cat([y, halo.reshape(b, 1, w, c).to(y.dtype)], dim=1)


def tv_sums_plain(y: torch.Tensor, halo=None) -> torch.Tensor:
    """(B, 2) per-lane (sum |dx|, sum |dy|) in y's dtype; with a halo row,
    the vertical sum also takes the pair (last row, halo)."""
    sx = (y[:, :, :-1, :] - y[:, :, 1:, :]).abs().sum(dim=(1, 2, 3))
    ext = _with_halo(y, halo)
    sy = (ext[:, :-1, :, :] - ext[:, 1:, :, :]).abs().sum(dim=(1, 2, 3))
    return torch.stack([sx, sy], dim=1)


def tv_plain(y: torch.Tensor, h_total=None, halo=None):
    """(tv (B,), means (B, 2)) in y's dtype (the forward kernel's plain
    version); with h_total (and a halo) a block's partial means."""
    _, h, w, c = y.shape
    h = h if h_total is None else h_total
    sums = tv_sums_plain(y, halo)
    means = torch.stack([sums[:, 0] / (h * (w - 1) * c),
                         sums[:, 1] / ((h - 1) * w * c)], dim=1)
    return means[:, 0] * means[:, 0] + means[:, 1] * means[:, 1], means


def _dx_part(y: torch.Tensor, h_total=None) -> torch.Tensor:
    _, h, w, c = y.shape
    h = h if h_total is None else h_total
    sx = torch.sign(y[:, :, :-1, :] - y[:, :, 1:, :]) / (h * (w - 1) * c)
    grad = torch.zeros_like(y)
    grad[:, :, :-1, :] += sx
    grad[:, :, 1:, :] -= sx
    return grad


def _dy_part(y: torch.Tensor, h_total=None) -> torch.Tensor:
    _, h, w, c = y.shape
    h = h if h_total is None else h_total
    sy = torch.sign(y[:, :-1, :, :] - y[:, 1:, :, :]) / ((h - 1) * w * c)
    grad = torch.zeros_like(y)
    grad[:, :-1, :, :] += sy
    grad[:, 1:, :, :] -= sy
    return grad


def tv_bwd_plain(y: torch.Tensor, g: torch.Tensor, means: torch.Tensor,
                 h_total=None, halo=None):
    """g[b] * d tv[b] / d y[b] for every lane (the backward kernel's plain
    version): g (B,), means (B, 2) from the forward. With h_total and a
    halo, a block's part of the image's gradient and the halo row's
    gradient (B, w*c)."""
    kx = (g * (2.0 * means[:, 0])).reshape(-1, 1, 1, 1)
    ky = (g * (2.0 * means[:, 1])).reshape(-1, 1, 1, 1)
    if halo is None:
        return kx * _dx_part(y, h_total) + ky * _dy_part(y, h_total)
    b, h, w, c = y.shape
    dy = _dy_part(_with_halo(y, halo), y.shape[1] if h_total is None
                  else h_total)
    grad = kx * _dx_part(y, h_total) + ky * dy[:, :h]
    return grad, (ky * dy[:, h:]).reshape(b, w * c)


def vec_width(w: int, c: int, data_ptr: int = 0) -> int:
    """Floats per lane access: 4 (16 bytes) when every row starts on a
    16-byte boundary, else 2 or 1."""
    for vec in (4, 2):
        if (w * c) % vec == 0 and data_ptr % (4 * vec) == 0:
            return vec
    return 1


def launch_plan(batch: int, h: int, w: int, c: int, sms: int, fit16: int,
                vec: int = 4) -> dict:
    """Both kernels' launch plan for `batch` lanes of h x w x c images on a
    card of `sms` SMs that holds `fit16` clusters of 16 full forward blocks
    at once (0: none); `vec` is vec_width's.

    A warp owns (32 - halo) * vec columns of a row (halo lanes on one side
    for the forward, both for the backward, ceil(c / vec) each) and walks
    a strip of rows. Forward: one cluster per lane, of 16 blocks where the
    batch's clusters all fit the card at once, else of 8; blocks grow to 32
    warps before strips shrink below _FWD_MIN_ROWS rows.
    Backward: blocks of _BWD_WARPS warps, strips long enough for about
    _BWD_WARPS_PER_SM warps per SM over the batch."""
    if vec not in (1, 2, 4) or (w * c) % vec:
        raise ValueError(f"tv: vec {vec} does not divide w*c = {w * c}")
    W = w * c
    halo = -(-c // vec)
    fwd_cols = (_WARP - halo) * vec
    nseg = -(-W // fwd_cols)
    cluster = 16 if batch <= fit16 else 8
    units = nseg * -(-h // _FWD_MIN_ROWS)
    warps = max(1, min(_FWD_MAX_WARPS, -(-units // cluster)))
    strips = max(1, min(-(-h // _FWD_MIN_ROWS), cluster * warps // nseg))
    fwd_rows = -(-h // strips)

    bseg = -(-W // ((_WARP - 2 * halo) * vec))
    lo, hi = _BWD_ROWS
    bwd_rows = max(lo, min(hi, -(-batch * h * bseg
                                 // (_BWD_WARPS_PER_SM * sms))))
    bunits = bseg * -(-h // bwd_rows)
    return dict(vec=vec, cluster=cluster, fwd_warps=warps, fwd_rows=fwd_rows,
                fwd_units=nseg * -(-h // fwd_rows),
                bwd_blocks=-(-bunits // _BWD_WARPS), bwd_warps=_BWD_WARPS,
                bwd_rows=bwd_rows, bwd_units=bunits)


def _lib():
    lib = build.load("tv")
    if lib.astt_tv_fwd.argtypes is None:
        i, p, i64 = ctypes.c_int, ctypes.c_void_p, ctypes.c_int64
        lib.astt_tv_fwd.argtypes = [p, p, i, i, i, i, i, i, i, i, i, p,
                                    i, p]
        lib.astt_tv_fwd_clusters.argtypes = [i, i, i, i, i,
                                             ctypes.POINTER(ctypes.c_int)]
        lib.astt_tv_bwd.argtypes = [p, p, i64, p, i64, p, i, i, i, i, i, i,
                                    i, i, i, p, p, i, p]
        for fn in (lib.astt_tv_fwd, lib.astt_tv_fwd_clusters, lib.astt_tv_bwd):
            fn.restype = ctypes.c_int
    return lib


def max_clusters(cluster: int, index: int, warps: int = _FWD_MAX_WARPS,
                 vec: int = 4, c: int = 3) -> int:
    """How many clusters of `cluster` forward blocks of `warps` warps CUDA
    device `index` holds at once (cudaOccupancyMaxActiveClusters)."""
    n = ctypes.c_int(0)
    with torch.cuda.device(index):  # the attributes and the query are
        # the current device's
        build.check(_lib().astt_tv_fwd_clusters(vec, c, cluster, warps,
                                                index, ctypes.byref(n)), "tv")
    return n.value


@functools.lru_cache(maxsize=None)
def _device_limits(index: int):
    """(SM count, clusters of 16 full forward blocks held at once) of CUDA
    device `index`, read once."""
    if max_clusters(8, index) < 1:
        raise RuntimeError(f"tv: device {index} holds no cluster of 8 "
                           f"blocks of {32 * _FWD_MAX_WARPS} threads")
    return (torch.cuda.get_device_properties(index).multi_processor_count,
            max_clusters(16, index))


@functools.lru_cache(maxsize=1024)
def _plan(index: int, batch: int, h: int, w: int, c: int, vec: int) -> dict:
    return launch_plan(batch, h, w, c, *_device_limits(index), vec)


def _check_y(y: torch.Tensor, what: str) -> None:
    if not y.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {y.device}")
    if y.dtype != torch.float32:
        raise TypeError(f"{what}: dtype {y.dtype} not supported (float32)")
    if y.dim() != 4:
        raise ValueError(f"{what}: expected an NHWC batch, got "
                         f"{tuple(y.shape)}")
    b, h, w, c = y.shape
    if b < 1 or h < 2 or w < 2 or not 1 <= c <= _MAX_C:
        raise ValueError(f"{what}: needs B >= 1, h >= 2, w >= 2 and "
                         f"1 <= c <= {_MAX_C}, got {tuple(y.shape)}")
    if not y.is_contiguous():
        raise ValueError(f"{what}: y must be contiguous NHWC")
    if h * w * c >= 2 ** 31:
        raise ValueError(f"{what}: an image of {h * w * c} elements exceeds "
                         "32-bit indexing")
    if b > _MAX_LANES:
        raise ValueError(f"{what}: {b} lanes exceed the grid's {_MAX_LANES}")


def _seam_args(y: torch.Tensor, h_total, halo, what: str):
    """(h_total, the halo's data pointer or None) of a kernel call, with
    the halo checked: a contiguous (B, w*c) float32 tensor on y's card."""
    b, h, w, c = y.shape
    h_total = h if h_total is None else int(h_total)
    if h_total < h or h_total < 2:
        raise ValueError(f"{what}: h_total {h_total} is below the block's "
                         f"{h} rows")
    if halo is None:
        return h_total, None
    if (not halo.is_cuda or halo.device != y.device
            or halo.dtype != torch.float32 or tuple(halo.shape) != (b, w * c)
            or not halo.is_contiguous()):
        raise ValueError(f"{what}: the halo must be a contiguous ({b}, "
                         f"{w * c}) float32 tensor on {y.device}")
    return h_total, halo.data_ptr()


def _vec(y: torch.Tensor, halo) -> int:
    _, _, w, c = y.shape
    vec = vec_width(w, c, y.data_ptr())
    if halo is not None:
        vec = min(vec, vec_width(w, c, halo.data_ptr()))
    return vec


def _tv_out(y: torch.Tensor, h_total=None, halo=None) -> torch.Tensor:
    """The forward kernel's (B, 5) float32 output: each lane's (tv,
    mean_x, mean_y, sum_x, sum_y); one launch."""
    _check_y(y, "tv")
    h_total, halo_ptr = _seam_args(y, h_total, halo, "tv")
    b, h, w, c = y.shape
    index = y.device.index
    vec = _vec(y, halo)
    plan = _plan(index, b, h, w, c, vec)
    with torch.cuda.device(y.device):  # the launch goes to the current one
        out = torch.empty((b, 5), dtype=torch.float32, device=y.device)
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = _lib().astt_tv_fwd(
            y.data_ptr(), halo_ptr, b, h, h_total, w, c, vec,
            plan["cluster"], plan["fwd_warps"], plan["fwd_rows"],
            out.data_ptr(), index, stream)
    build.check(err, "tv")
    launched("tv", stream, index)
    return out


def tv_cuda(y: torch.Tensor, h_total=None, halo=None):
    """The forward kernel on a CUDA tensor (no fallback): (tv (B,),
    means (B, 2)), views of one buffer; one launch."""
    out = _tv_out(y, h_total, halo)
    return out[:, 0], out[:, 1:3]


def tv_bwd_cuda(y: torch.Tensor, g: torch.Tensor, means: torch.Tensor,
                h_total=None, halo=None):
    """The backward kernel on CUDA tensors (no fallback): g (B,) of any
    stride, means (B, 2) with unit column stride (tv_cuda's); one launch.
    With a halo, (grad, the halo row's gradient)."""
    _check_y(y, "tv_bwd")
    h_total, halo_ptr = _seam_args(y, h_total, halo, "tv_bwd")
    b, h, w, c = y.shape
    for name, t, shape in (("g", g, (b,)), ("means", means, (b, 2))):
        if (not t.is_cuda or t.device != y.device or t.dtype != torch.float32
                or tuple(t.shape) != shape):
            raise ValueError(f"tv_bwd: {name} must be a {shape} float32 "
                             f"tensor on {y.device}")
    if means.stride(1) != 1:
        raise ValueError("tv_bwd: means must have unit column stride")
    index = y.device.index
    vec = _vec(y, halo)
    plan = _plan(index, b, h, w, c, vec)
    with torch.cuda.device(y.device):  # the launch goes to the current one
        grad = torch.empty_like(y, memory_format=torch.contiguous_format)
        halo_grad = (None if halo is None else
                     torch.empty((b, w * c), dtype=torch.float32,
                                 device=y.device))
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = _lib().astt_tv_bwd(
            y.data_ptr(), g.data_ptr(), g.stride(0), means.data_ptr(),
            means.stride(0), halo_ptr, b, h, h_total, w, c, vec,
            plan["bwd_blocks"], plan["bwd_warps"], plan["bwd_rows"],
            grad.data_ptr(),
            None if halo_grad is None else halo_grad.data_ptr(), index,
            stream)
    build.check(err, "tv_bwd")
    launched("tv_bwd", stream, index)
    return grad if halo is None else (grad, halo_grad)


def tv(y: torch.Tensor, h_total=None, halo=None):
    """(tv (B,), means (B, 2)): the kernel for a CUDA tensor, the plain
    version for a CPU tensor. h_total and halo: a block's partial means
    (see the module docstring)."""
    if y.is_cuda:
        return tv_cuda(y, h_total, halo)
    if y.device.type == "cpu":
        return tv_plain(y, h_total, halo)
    raise ValueError(f"tv: unsupported device {y.device}")


def tv_bwd(y: torch.Tensor, g: torch.Tensor, means: torch.Tensor,
           h_total=None, halo=None):
    """The gradient of sum_b g[b] tv[b]: the kernel for CUDA tensors, the
    plain version on the CPU. With a halo, (the block's gradient, the halo
    row's gradient) (see the module docstring)."""
    if y.is_cuda:
        return tv_bwd_cuda(y, g, means, h_total, halo)
    if y.device.type == "cpu":
        return tv_bwd_plain(y, g, means, h_total, halo)
    raise ValueError(f"tv_bwd: unsupported device {y.device}")


def tv_lane_sums(y: torch.Tensor) -> torch.Tensor:
    """(B, 2) per-lane (sum |dx|, sum |dy|): from the forward kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if y.is_cuda:
        return _tv_out(y)[:, 3:]
    if y.device.type == "cpu":
        return tv_sums_plain(y)
    raise ValueError(f"tv: unsupported device {y.device}")


def tv_sums(y: torch.Tensor):
    """(sx, sy) of the whole batch, as 0-d float32 tensors."""
    sx, sy = tv_lane_sums(y).sum(dim=0)
    return sx, sy
