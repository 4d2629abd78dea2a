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

