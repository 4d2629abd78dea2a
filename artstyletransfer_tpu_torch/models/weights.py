"""VGG19 weight loading, deterministic initialization and conversion.

Weights are kept in the repo's weight format — numpy HWIO kernels keyed
by conv name, the same as the JAX package — and resolved, in order, from

  1. an explicit ``.npz`` path,
  2. the ``ASTT_VGG19_WEIGHTS`` environment variable (either naming a
     missing file is a loud ``FileNotFoundError``),
  3. a seeded He-normal initialization (numpy ``default_rng``: one seed
     gives the same weights as the JAX package's ``init_vgg19_params``).

``params_from_jax`` turns that format into the OIHW torch tensors the
port's VGG19 runs on, and ``shared_params`` keeps one such copy per
source and device for every job that names that source. Loading torchvision ``.pth`` and Keras ``.h5`` files
is not ported yet.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.cache import BoundedCache
from .vgg19 import CONV_NAMES, param_shapes

_ENV_VAR = "ASTT_VGG19_WEIGHTS"

NpParams = Dict[str, Dict[str, np.ndarray]]


def init_vgg19_params(seed: int = 0, dtype=np.float32) -> NpParams:
    """Deterministic He-normal init of the truncated VGG19 stack (HWIO)."""
    rng = np.random.default_rng(seed)
    params: NpParams = {}
    for name, shp in param_shapes().items():
        kh, kw, cin, cout = shp["w"]
        std = np.sqrt(2.0 / (kh * kw * cin))
        params[name] = {
            "w": (rng.standard_normal(shp["w"]) * std).astype(dtype),
            "b": np.zeros(shp["b"], dtype=dtype),
        }
    return params


def save_vgg19_params(params: NpParams, path: str) -> None:
    arrays = {}
    for name in CONV_NAMES:
        arrays[f"{name}_w"] = np.asarray(params[name]["w"], dtype=np.float32)
        arrays[f"{name}_b"] = np.asarray(params[name]["b"], dtype=np.float32)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def _load_npz(path: str) -> NpParams:
    with np.load(path) as data:
        return {name: {"w": data[f"{name}_w"], "b": data[f"{name}_b"]}
                for name in CONV_NAMES}


def _validate(params: NpParams) -> NpParams:
    shapes = param_shapes()
    for name in CONV_NAMES:
        got_w = tuple(params[name]["w"].shape)
        want_w = shapes[name]["w"]
        if got_w != want_w:
            raise ValueError(f"{name}: kernel shape {got_w} != expected {want_w}")
    return params


def load_vgg19_params(path: Optional[str] = None, seed: int = 0) -> NpParams:
    """Resolve VGG19 weights (see the module docstring for the order)."""
    env = os.environ.get(_ENV_VAR)
    for cand in (path, env):
        if not cand:
            continue
        if not os.path.exists(cand):
            raise FileNotFoundError(f"VGG19 weights not found: {cand}")
        if not cand.endswith(".npz"):
            raise NotImplementedError(
                f"{cand}: only .npz weights load in this package so far "
                "(.pth/.h5 conversion is not ported yet)")
        return _validate(_load_npz(cand))
    return init_vgg19_params(seed=seed)


def params_from_jax(np_params: NpParams, device="cpu"):
    """Repo-format weights (HWIO numpy, as the JAX package holds them) ->
    {name: {'w': OIHW float32 tensor, 'b': tensor}} on `device`.

    Kernels are stored channels_last so cuDNN keeps the activations in
    the NHWC memory the taps are read in."""
    out = {}
    for name in CONV_NAMES:
        w = torch.from_numpy(np.asarray(np_params[name]["w"], np.float32))
        w = w.permute(3, 2, 0, 1).to(device)  # HWIO -> OIHW
        out[name] = {
            "w": w.contiguous(memory_format=torch.channels_last),
            "b": torch.from_numpy(
                np.asarray(np_params[name]["b"], np.float32)).to(device),
        }
    return out


_SHARED = BoundedCache(4)
_shared_lock = threading.Lock()


def shared_params(np_params: Optional[NpParams], seed: int, device):
    """A job's device weights: params_from_jax of np_params (or of
    load_vgg19_params(seed=seed) when it is None) on `device`, converted
    once per source and device and shared by every job of that source.

    A source is the np_params object itself (by identity), or for None
    the seed and the weights file the environment names (path and
    modification time). The captured evaluations (engine/graphs.py) bind
    the weights' tensors, so jobs share a graph only when they share
    these. The last 4 sources are kept."""
    dev = str(torch.device(device))
    if np_params is None:
        env = os.environ.get(_ENV_VAR)
        stamp = (os.stat(env).st_mtime_ns
                 if env and os.path.exists(env) else None)
        key = ("seed", seed, env, stamp, dev)
    else:
        key = ("object", id(np_params), dev)
    with _shared_lock:
        if key in _SHARED and _SHARED[key][0] is np_params:
            return _SHARED[key][1]
        src = (np_params if np_params is not None
               else load_vgg19_params(seed=seed))
        out = params_from_jax(src, device)
        # the source object is kept with its copy, so its id is not reused
        _SHARED[key] = (np_params, out)
        return out
