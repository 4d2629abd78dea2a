"""The style-transfer objective in plain PyTorch, float32 without TF32.

VGG19 through conv5_1 (arXiv:1409.1556; torchvision's layer order) with
the six taps the reference repository reads: relu1_1, relu2_1, relu3_1,
relu4_1, conv4_2 (before its ReLU) and relu5_1; content on conv4_2, style
on the other five. One pyramid level's loss is

  content_weight * mean((F - Fc)^2)
  + style_weight * mean over the five taps of mean((G - Gs)^2)
  + tv_weight * ((mean |dx|)^2 + (mean |dy|)^2)

with G = F^T F / (c h w) of the (h w, c) feature matrix, and the levels'
losses add up; each lower level's image is the bicubic half of the one
above it. No kernel of the port, no CUDA graph, no batching of jobs: one
image at a time, by torch's own operations.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import images

LAYERS = (("conv1_1", 64), ("conv1_2", 64), ("pool", 0),
          ("conv2_1", 128), ("conv2_2", 128), ("pool", 0),
          ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256),
          ("conv3_4", 256), ("pool", 0),
          ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512),
          ("conv4_4", 512), ("pool", 0),
          ("conv5_1", 512))
CONTENT_TAP = "conv4_2"  # before its ReLU
STYLE_TAPS = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1")  # after

Weights = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


@contextlib.contextmanager
def full_float32():
    """Float32 convolutions and matmuls (TF32 off), restored on exit."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def weights_from_hwio(hwio: Dict[str, Dict[str, np.ndarray]],
                      device) -> Weights:
    """{conv: (OIHW kernel, bias)} from {conv: {'w': HWIO, 'b': (cout,)}}."""
    return {name: (torch.as_tensor(np.asarray(p["w"], np.float32))
                   .permute(3, 2, 0, 1).contiguous().to(device),
                   torch.as_tensor(np.asarray(p["b"], np.float32)).to(device))
            for name, p in hwio.items()}


def taps(weights: Weights, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """{tap: (B, h, w, c) map} of an NHWC batch."""
    out = {}
    h = x.permute(0, 3, 1, 2)
    for name, _ in LAYERS:
        if name == "pool":
            h = F.max_pool2d(h, 2, 2)
            continue
        w, b = weights[name]
        h = F.conv2d(h, w, b, padding=1)
        if name == CONTENT_TAP:
            out[name] = h
        h = F.relu(h)
        if name in STYLE_TAPS:
            out[name] = h
        if name == "conv5_1":
            break
    return {k: v.permute(0, 2, 3, 1) for k, v in out.items()}


def gram(f: torch.Tensor) -> torch.Tensor:
    """(B, c, c) F^T F / (c h w) of an NHWC map."""
    b, h, w, c = f.shape
    m = f.reshape(b, h * w, c)
    return m.transpose(1, 2) @ m / (c * h * w)


def tv(y: torch.Tensor) -> torch.Tensor:
    """(B,) (mean |dx|)^2 + (mean |dy|)^2 of an NHWC batch."""
    dx = (y[:, :, :-1, :] - y[:, :, 1:, :]).abs().flatten(1).mean(1)
    dy = (y[:, :-1, :, :] - y[:, 1:, :, :]).abs().flatten(1).mean(1)
    return dx * dx + dy * dy


@functools.lru_cache(maxsize=16)
def _matrix(n_in: int, n_out: int, device: str) -> torch.Tensor:
    return torch.from_numpy(images.resize_matrix(n_in, n_out)).to(device)


def downscale2x(y: torch.Tensor) -> torch.Tensor:
    """The bicubic half (floor) of an NHWC batch, by the two matrices."""
    _, h, w, _ = y.shape
    rh = _matrix(h, h // 2, str(y.device))
    rw = _matrix(w, w // 2, str(y.device))
    y = torch.einsum("iy,byxc->bixc", rh, y)
    return torch.einsum("jx,bixc->bijc", rw, y)


class Objective:
    """One job's pyramid loss, built from its raw images and the weights:
    the input pyramids and the targets are worked out here, never taken
    from the program."""

    def __init__(self, content: np.ndarray, style: np.ndarray, cfg: dict,
                 weights: Weights, device):
        self.cfg = cfg
        self.weights = weights
        c_lv, s_lv = images.pyramids(content, style, cfg["levels_num"],
                                     cfg["base_diameter"])
        self.top_shape = images.prepare(c_lv[0]).shape
        self.targets = []
        with torch.no_grad():
            for c_img, s_img in zip(c_lv, s_lv):
                ct = taps(weights, torch.from_numpy(
                    images.prepare(c_img)).to(device))
                st = taps(weights, torch.from_numpy(
                    images.prepare(s_img)).to(device))
                self.targets.append((ct[CONTENT_TAP],
                                     [gram(st[t]) for t in STYLE_TAPS]))

    def level_losses(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Each level's (B,) loss at the flattened top-level batch x."""
        cfg = self.cfg
        cur = x.reshape((-1,) + tuple(self.top_shape[1:]))
        out = []
        for lvl, (t_content, t_grams) in enumerate(self.targets):
            if lvl:
                cur = downscale2x(cur)
            f = taps(self.weights, cur)
            content = (f[CONTENT_TAP] - t_content).square().flatten(1).mean(1)
            style = sum((gram(f[t]) - g).square().flatten(1).mean(1)
                        for t, g in zip(STYLE_TAPS, t_grams)) / len(t_grams)
            out.append(cfg["content_weight"] * content
                       + cfg["style_weight"] * style
                       + cfg["tv_weight"] * tv(cur))
        return out

    def loss(self, x: torch.Tensor) -> torch.Tensor:
        """(B,) total loss."""
        return sum(self.level_losses(x))

