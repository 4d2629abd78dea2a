"""VGG19 feature extractor, truncated at conv5_1, as plain PyTorch.

Same network and taps as the JAX package's ``models/vgg19.py``: the six
taps ['relu1_1', 'relu2_1', 'relu3_1', 'relu4_1', 'conv4_2', 'relu5_1'],
content index 4 (conv4_2, always pre-ReLU), style indices (0, 1, 2, 3, 5),
2x2 max-pools that floor odd sizes, and nothing past conv5_1.

Layouts: the public input and the taps are NHWC, like the JAX package. In
between, the convolutions see NCHW tensors in channels_last memory — the
NHWC buffer viewed through a permute — so no layout copy happens at either
boundary and each tap reshapes to the (h·w, c) feature matrix for free.
The convolutions are F.conv2d (cuDNN on the card); the JAX package leaves
them to XLA as well. extract_features runs each block of the stack (the
convs up to a pool) as one autograd node, Vgg19Fn: between the
convolutions, one pass of kernels/vgg_glue.py each way per convolution
(bias, ReLU and the 2x2 pool forward; the ReLU mask, the pool's routing
and a tap's gradient backward), with the per-op path's numbers. The
row-block form (extract_features_blocks, parallel/space.py) runs the same
passes on each block after its halo'd convolution, one node a block and
layer (BlockGlueFn).

compute_dtype 'bfloat16' runs the convs on bf16 weights and activations;
the taps stay bf16 and the loss code accumulates in float32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels import vgg_glue as kglue
from ..ops.blocks import halos, on_block

LAYER_NAMES = ("relu1_1", "relu2_1", "relu3_1", "relu4_1", "conv4_2", "relu5_1")
CONTENT_INDEX = 4  # conv4_2
STYLE_INDICES = (0, 1, 2, 3, 5)  # everything except conv4_2

VGG19_LAYERS = (
    ("conv1_1", 64), ("conv1_2", 64),
    ("pool", 0),
    ("conv2_1", 128), ("conv2_2", 128),
    ("pool", 0),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256),
    ("pool", 0),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512),
    ("pool", 0),
    ("conv5_1", 512),
)

CONV_NAMES = tuple(n for n, _ in VGG19_LAYERS if n != "pool")

# conv4_2 is captured PRE-ReLU; every other tap is post-ReLU.
_TAPS = {
    "relu1_1": ("conv1_1", "post"),
    "relu2_1": ("conv2_1", "post"),
    "relu3_1": ("conv3_1", "post"),
    "relu4_1": ("conv4_1", "post"),
    "conv4_2": ("conv4_2", "pre"),
    "relu5_1": ("conv5_1", "post"),
}


class Vgg19Features(NamedTuple):
    """The six feature taps, NHWC."""

    relu1_1: torch.Tensor
    relu2_1: torch.Tensor
    relu3_1: torch.Tensor
    relu4_1: torch.Tensor
    conv4_2: torch.Tensor
    relu5_1: torch.Tensor


Params = Dict[str, Dict[str, torch.Tensor]]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _Layer(NamedTuple):
    name: str
    pool: bool          # a 2x2 max-pool follows
    tap: Optional[str]  # the tap it gives, if any
    tap_pre: bool       # the tap is pre-ReLU


def _plan(use_relu: bool):
    """The 13 convs' layers: use_relu exposes post-ReLU taps, else every
    tap is pre-ReLU; conv4_2 is pre-ReLU either way."""
    taps = {src: (tap, kind == "pre" or not use_relu)
            for tap, (src, kind) in _TAPS.items()}
    names = [n for n, _ in VGG19_LAYERS]
    return tuple(_Layer(n, k + 1 < len(names) and names[k + 1] == "pool",
                        *taps.get(n, (None, False)))
                 for k, n in enumerate(names) if n != "pool")


def _conv_adds_bias(device: torch.device) -> bool:
    """Where the per-op path's bias add happens: inside the convolution on
    the CPU (oneDNN), as a separate pass after it on the card (cuDNN)."""
    return device.type == "cpu"


# [first, end) of the convs of each node: a node ends at each pool and at
# conv5_1 (VGG19's blocks)
_ENDS = tuple(k + 1 for k, layer in enumerate(_plan(True)) if layer.pool)
_BLOCKS = tuple(zip((0,) + _ENDS, _ENDS + (len(CONV_NAMES),)))


class Vgg19Fn(torch.autograd.Function):
    """One block of the truncated VGG19 stack as one autograd node:
    apply(use_relu, first, h, *weights, *biases) for the convs
    _plan(use_relu)[first:first + len(weights)], h their NCHW
    (channels_last) input in the convs' dtype (the weights and biases
    take no gradient); returns the block's taps, NCHW, in LAYER_NAMES
    order, then its pooled map where the block ends with a pool.

    Forward, per conv: F.conv2d without its bias on the card (cuDNN's
    path adds a bias after the convolution, as a separate pass) and with
    it on the CPU (oneDNN adds it inside the convolution: one rounding in
    bfloat16), then one kernels.vgg_glue.glue pass: the bias, ReLU, a
    pre-ReLU tap kept, and on conv1_2, conv2_2, conv3_4 and conv4_4 the
    2x2 pool, which keeps a byte per pooled value in place of the
    full-size map and int64 indices. Saved where h takes a gradient:
    each conv's input (the previous layer's post-ReLU map or pooled map),
    the pool's code or conv5_1's post-ReLU tap, the weights.

    Backward, per conv from the block's last down: one glue_bwd pass (the
    tap's gradient added before the ReLU mask for a post-ReLU tap, after
    it for a pre-ReLU one; on a pool layer the routing of the next
    block's gradient), then cuDNN's data gradient through
    aten.convolution_backward with the arguments autograd's
    ConvolutionBackward0 passes, so the same algorithms run. Every step
    is the per-op path's arithmetic, so the loss and the gradient are
    that path's bit for bit. A node holds its saved maps and its taps'
    gradients until its backward returns, where the per-op path freed
    each op's as it went: one node over all 13 convs held a level's
    until its conv1_1, and the captured 2048 px evaluation outgrew the
    card at a 3-lane L-BFGS group; one node a block frees them a block
    at a time."""

    @staticmethod
    def forward(ctx, use_relu: bool, first: int, h: torch.Tensor, *params):
        n = len(params) // 2
        ws, bs = params[:n], params[n:]
        if any(p.requires_grad for p in params):
            raise ValueError("Vgg19Fn: the weights take no gradient")
        plan = _plan(use_relu)[first:first + n]
        in_conv = _conv_adds_bias(h.device)
        # without a gradient to come (the targets), each map goes as soon
        # as the next conv has read it, as the per-op path's do
        keep = ctx.needs_input_grad[2]
        inputs, taps = [], []
        for k, layer in enumerate(plan):
            if keep:
                inputs.append(h)
            y = F.conv2d(h, ws[k], bs[k] if in_conv else None, padding=1)
            last = first + k + 1 == len(CONV_NAMES)
            pre, h, code = kglue.glue(
                y, None if in_conv else bs[k], pool=layer.pool,
                keep_pre=layer.tap_pre,
                keep_post=not (last and layer.tap_pre))
            if layer.tap is not None:
                taps.append(pre if layer.tap_pre else h)
        pooled = plan[-1].pool
        ctx.use_relu, ctx.first, ctx.n = use_relu, first, n
        ctx.set_materialize_grads(False)
        if keep:
            # the pool's code, or conv5_1's post-ReLU tap for its mask
            end = code if pooled else h
            ctx.save_for_backward(*inputs, *(() if end is None else (end,)),
                                  *ws)
        return (*taps, h) if pooled else tuple(taps)

    @staticmethod
    def backward(ctx, *grads):
        n = ctx.n
        plan = _plan(ctx.use_relu)[ctx.first:ctx.first + n]
        saved = ctx.saved_tensors
        inputs, end, ws = saved[:n], saved[n:-n], saved[-n:]
        cl = torch.channels_last
        tap_grads = dict(zip((l.tap for l in plan if l.tap is not None),
                             grads))
        g = grads[-1] if plan[-1].pool else None  # at the pooled map
        for k in reversed(range(n)):
            layer = plan[k]
            t = tap_grads.get(layer.tap)
            if t is not None:
                t = t.contiguous(memory_format=cl)
            if g is not None:
                g = g.contiguous(memory_format=cl)
            if layer.pool:
                gy = None if g is None else kglue.glue_bwd(
                    g, code=end[0], size=tuple(inputs[k].shape[2:]))
            elif g is None and (t is None or layer.tap_pre):
                gy = t  # a pre-ReLU tap's gradient alone, or nothing
            else:
                post = inputs[k + 1] if k + 1 < n else end[0]
                gy = kglue.glue_bwd(g, post=post, tap=t,
                                    tap_after=layer.tap_pre)
            if gy is None:
                g = None
                continue
            w = ws[k]
            g = torch.ops.aten.convolution_backward(
                gy, inputs[k], w, [w.shape[0]], [1, 1], [1, 1], [1, 1],
                False, [0, 0], 1, [True, False, False])[0]
        return (None, None, g) + (None,) * (2 * n)


def extract_features(params: Params, x: torch.Tensor,
                     compute_dtype: str = "float32",
                     use_relu: bool = True) -> Vgg19Features:
    """Run the truncated VGG19 stack (Vgg19Fn, a node a block) and return
    the six taps.

    Args:
      params: {conv_name: {'w': (Cout, Cin, 3, 3) OIHW, 'b': (Cout,)}}, as
        made by models.weights.params_from_jax, on x's device.
      x: preprocessed image batch, NHWC (pixels*255 - ImageNet mean).
      compute_dtype: 'float32' or 'bfloat16' for the convs.
      use_relu: True exposes post-ReLU taps; False the pre-ReLU conv taps.
        conv4_2 is pre-ReLU either way.

    Returns:
      Vgg19Features of NHWC maps in compute_dtype.
    """
    cdt = _DTYPES[compute_dtype]
    h = x.to(cdt).permute(0, 3, 1, 2)  # NCHW view of NHWC = channels_last
    ws = [params[n]["w"].to(cdt) for n in CONV_NAMES]
    bs = [params[n]["b"].to(cdt) for n in CONV_NAMES]
    taps = []
    for first, end in _BLOCKS:
        out = Vgg19Fn.apply(use_relu, first, h, *ws[first:end],
                            *bs[first:end])
        if end < len(CONV_NAMES):
            *out, h = out
        taps += out
    return Vgg19Features(*(t.permute(0, 2, 3, 1) for t in taps))


def _extend(h: torch.Tensor, up, dn) -> torch.Tensor:
    """An NCHW channels_last block with a halo row above and below (a
    zero row at the image's top and bottom)."""
    zero = None
    if up is None or dn is None:
        b, c, _, w = h.shape
        zero = torch.empty((b, c, 1, w), dtype=h.dtype, device=h.device,
                           memory_format=torch.channels_last).zero_()
    return torch.cat([zero if up is None else up, h,
                      zero if dn is None else dn], dim=2)


class HaloConvFn(torch.autograd.Function):
    """The 3x3 SAME convolution of an NCHW image held as its row blocks:
    apply(n, *blocks, *weights, *biases), block k on its own device with
    its copies of the weights (which take no gradient). Forward: each
    block with the neighbours' facing rows (a zero row at the image's
    top and bottom) through F.conv2d with padding (0, 1), as the whole
    image runs with padding 1. Backward: each block's input gradient
    (the transposed convolution: cuDNN's data gradient, which needs
    nothing of the forward but the weights), and each
    halo row's part added to the row it came from, in block order. One
    node for every block: autograd's per-device threads would add a
    block's gradient contributions in the order they arrive."""

    @staticmethod
    def forward(ctx, n: int, *args):
        hs, ws, bs = args[:n], args[n:2 * n], args[2 * n:]
        if any(w.requires_grad or b.requires_grad for w, b in zip(ws, bs)):
            raise ValueError("HaloConvFn: the weights take no gradient")
        ctx.weights = ws  # arguments of the loss, never part of its graph
        out = []
        for k, (h, (up, dn)) in enumerate(zip(hs, halos(hs, 2))):
            with on_block(k):
                out.append(F.conv2d(_extend(h, up, dn), ws[k], bs[k],
                                    padding=(0, 1)))
        return tuple(out)

    @staticmethod
    def backward(ctx, *gouts):
        # the data gradient of a padding (0, 1) convolution: rows h + 2
        exts = [F.conv_transpose2d(g, w, padding=(0, 1))
                for g, w in zip(gouts, ctx.weights)]
        grads = [e[:, :, 1:-1] for e in exts]
        for k, e in enumerate(exts):
            if k > 0:
                grads[k - 1][:, :, -1:] += e[:, :, :1].to(grads[k - 1].device)
            if k + 1 < len(exts):
                grads[k + 1][:, :, :1] += e[:, :, -1:].to(grads[k + 1].device)
        return (None, *grads) + (None,) * (2 * len(exts))


def halo_conv(hs, ws, bs):
    """The 3x3 SAME convolution of an NCHW image held as its row blocks
    (parallel/space.py; block k on its own device, with ws[k], bs[k] its
    copies of the weights and bias): HaloConvFn. Every block has 2 rows
    or more at the shapes parallel/space.py's gate lets through."""
    return list(HaloConvFn.apply(len(hs), *hs, *ws, *bs))


class BlockGlueFn(torch.autograd.Function):
    """The ReLU, and on a pool layer the 2x2 pool, of one row block's
    convolution output (its bias added by the convolution) as one
    kernels.vgg_glue pass each way: apply(y, pool) -> post-ReLU map or
    pooled map. Saves the post-ReLU map for the mask, or on a pool layer
    the pool's code byte in place of the full-size map and int64 indices.
    A tap's gradient reaches the block's map through autograd's add, as
    it did with F.relu and F.max_pool2d, so the numbers are theirs."""

    @staticmethod
    def forward(ctx, y: torch.Tensor, pool: bool):
        _, out, code = kglue.glue(y, None, pool=pool)
        ctx.pool, ctx.size = pool, tuple(y.shape[2:])
        ctx.save_for_backward(code if pool else out)
        return out

    @staticmethod
    def backward(ctx, g):
        saved, = ctx.saved_tensors
        g = g.contiguous(memory_format=torch.channels_last)
        if ctx.pool:
            return kglue.glue_bwd(g, code=saved, size=ctx.size), None
        return kglue.glue_bwd(g, post=saved), None


def extract_features_blocks(params, xs, compute_dtype: str = "float32",
                            use_relu: bool = True):
    """extract_features of one image batch held as its row blocks
    (parallel/space.py): xs[k] the (B, h/S, w, 3) NHWC rows of block k on
    the space row's k-th device, params[k] the weights there. Returns one
    Vgg19Features per block, each of its own rows of the six taps: the
    convs exchange a halo row with each neighbour (halo_conv), then each
    block's ReLU and 2x2 pool run as BlockGlueFn; the pools need no halo
    (every block starts on an even row and has an even height at each
    pool)."""
    cdt = _DTYPES[compute_dtype]
    taps_of = {}
    hs = [x.to(cdt).permute(0, 3, 1, 2) for x in xs]
    for layer in _plan(use_relu):
        hs = halo_conv(hs, [p[layer.name]["w"].to(cdt) for p in params],
                       [p[layer.name]["b"].to(cdt) for p in params])
        if layer.tap_pre:
            taps_of[layer.tap] = hs
            if layer.name == CONV_NAMES[-1]:
                break  # nothing past conv5_1 is ever used
        glued = []
        for k, h in enumerate(hs):
            with on_block(k):
                glued.append(BlockGlueFn.apply(h, layer.pool))
        hs = glued
        if layer.tap is not None and not layer.tap_pre:
            taps_of[layer.tap] = hs
    return [Vgg19Features(*(taps_of[n][k].permute(0, 2, 3, 1)
                            for n in LAYER_NAMES))
            for k in range(len(xs))]


def prepare_model(model: str):
    """(feature_fn, content_index, style_indices) for a model name."""
    if model == "vgg19":
        return extract_features, CONTENT_INDEX, list(STYLE_INDICES)
    raise ValueError(f"{model} not supported.")


def param_shapes() -> Dict[str, Dict[str, tuple]]:
    """Static shape table of the conv parameters in the repo's weight
    format (HWIO kernels, as stored in .npz files and made by
    models.weights.init_vgg19_params)."""
    shapes = {}
    cin = 3
    for name, cout in VGG19_LAYERS:
        if name == "pool":
            continue
        shapes[name] = {"w": (3, 3, cin, cout), "b": (cout,)}
        cin = cout
    return shapes

