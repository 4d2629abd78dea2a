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
them to XLA as well.

compute_dtype 'bfloat16' runs the convs on bf16 weights and activations;
the taps stay bf16 and the loss code accumulates in float32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

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


def extract_features(params: Params, x: torch.Tensor,
                     compute_dtype: str = "float32",
                     use_relu: bool = True) -> Vgg19Features:
    """Run the truncated VGG19 stack and return the six taps.

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
    if use_relu:
        pre_wanted = {src: tap for tap, (src, kind) in _TAPS.items()
                      if kind == "pre"}
        post_wanted = {src: tap for tap, (src, kind) in _TAPS.items()
                       if kind == "post"}
    else:
        pre_wanted = {src: tap for tap, (src, _kind) in _TAPS.items()}
        post_wanted = {}

    taps: Dict[str, torch.Tensor] = {}
    h = x.to(cdt).permute(0, 3, 1, 2)  # NCHW view of NHWC = channels_last
    for name, _ in VGG19_LAYERS:
        if name == "pool":
            h = F.max_pool2d(h, kernel_size=2, stride=2)
            continue
        p = params[name]
        h = F.conv2d(h, p["w"].to(cdt), p["b"].to(cdt), padding=1)
        if name in pre_wanted:
            taps[pre_wanted[name]] = h
        h = F.relu(h)
        if name in post_wanted:
            taps[post_wanted[name]] = h
        if name == "conv5_1":
            break  # nothing past relu5_1 is ever used

    return Vgg19Features(*(taps[n].permute(0, 2, 3, 1) for n in LAYER_NAMES))


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


def extract_features_blocks(params, xs, compute_dtype: str = "float32",
                            use_relu: bool = True):
    """extract_features of one image batch held as its row blocks
    (parallel/space.py): xs[k] the (B, h/S, w, 3) NHWC rows of block k on
    the space row's k-th device, params[k] the weights there. Returns one
    Vgg19Features per block, each of its own rows of the six taps: the
    convs exchange a halo row with each neighbour (halo_conv), and the
    2x2 pools need none (every block starts on an even row and has an
    even height at each pool)."""
    cdt = _DTYPES[compute_dtype]
    taps_of = {name: [] for name in LAYER_NAMES}
    wanted = {src: (tap, kind) for tap, (src, kind) in _TAPS.items()}
    hs = [x.to(cdt).permute(0, 3, 1, 2) for x in xs]
    for name, _ in VGG19_LAYERS:
        if name == "pool":
            pooled = []
            for k, h in enumerate(hs):
                with on_block(k):
                    pooled.append(F.max_pool2d(h, kernel_size=2, stride=2))
            hs = pooled
            continue
        hs = halo_conv(hs, [p[name]["w"].to(cdt) for p in params],
                       [p[name]["b"].to(cdt) for p in params])
        tap, kind = wanted.get(name, (None, None))
        if tap is not None and (kind == "pre" or not use_relu):
            taps_of[tap] = hs
        relu = []
        for k, h in enumerate(hs):
            with on_block(k):
                relu.append(F.relu(h))
        hs = relu
        if tap is not None and kind == "post" and use_relu:
            taps_of[tap] = hs
        if name == "conv5_1":
            break  # nothing past relu5_1 is ever used
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

