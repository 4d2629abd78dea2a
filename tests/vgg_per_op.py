"""The truncated VGG19 op by op under autograd, as the port's
extract_features ran it before Vgg19Fn: the oracle that
tests/test_torch_vgg_glue.py and chip_smoke.py hold the fused glue
against."""

import torch
import torch.nn.functional as F

from artstyletransfer_tpu_torch.models import vgg19 as V


def per_op_features(params, x, compute_dtype="float32", use_relu=True):
    """F.conv2d with its bias, F.relu and F.max_pool2d, layer by layer;
    extract_features' arguments and taps."""
    cdt = getattr(torch, compute_dtype)
    taps = {}
    h = x.to(cdt).permute(0, 3, 1, 2)
    for name, _ in V.VGG19_LAYERS:
        if name == "pool":
            h = F.max_pool2d(h, kernel_size=2, stride=2)
            continue
        tap, kind = next(((t, k) for t, (src, k) in V._TAPS.items()
                          if src == name), (None, None))
        p = params[name]
        h = F.conv2d(h, p["w"].to(cdt), p["b"].to(cdt), padding=1)
        if tap is not None and (kind == "pre" or not use_relu):
            taps[tap] = h
        h = F.relu(h)
        if tap is not None and kind == "post" and use_relu:
            taps[tap] = h
    return V.Vgg19Features(*(taps[n].permute(0, 2, 3, 1)
                             for n in V.LAYER_NAMES))
