"""VGG19 weight loading, conversion and deterministic initialization.

Weights are kept in the repo's weight format — numpy HWIO kernels keyed
by conv name, the same as the JAX package — and resolved, in order, from

  1. an explicit path: the native ``.npz``, a torchvision ``.pth`` state
     dict (``features.<idx>.weight``, OIHW) or a Keras ``.h5``,
  2. the ``ASTT_VGG19_WEIGHTS`` environment variable (either naming a
     missing file is a loud ``FileNotFoundError``),
  3. the cached native ``.npz`` under ``~/.cache/artstyletransfer_tpu/``,
     the JAX package's own cache file, so one installed file serves both
     packages (a stale entry falls through),
  4. a seeded He-normal initialization (numpy ``default_rng``: one seed
     gives the same weights as the JAX package's ``init_vgg19_params``).

A file found in 1 or 2 is converted once and written to the cache.
``convert_weights_main`` converts a file to ``.npz`` from the command line
(``python -m artstyletransfer_tpu_torch.models.weights vgg19.pth -o
vgg19.npz --install``). Nothing is downloaded.

``params_from_jax`` turns that format into the OIHW torch tensors the
port's VGG19 runs on, and ``shared_params`` keeps one such copy per
source and device for every job that names that source.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.cache import BoundedCache
from .vgg19 import CONV_NAMES, param_shapes

_CACHE_DIR = os.path.join(os.path.expanduser("~"), ".cache",
                          "artstyletransfer_tpu")
_CACHE_FILE = os.path.join(_CACHE_DIR, "vgg19_features.npz")
_ENV_VAR = "ASTT_VGG19_WEIGHTS"

# torchvision vgg19.features module index of each conv layer, for a
# torchvision state dict (features.<idx>.weight, OIHW layout)
_TORCHVISION_INDICES = {
    "conv1_1": 0, "conv1_2": 2,
    "conv2_1": 5, "conv2_2": 7,
    "conv3_1": 10, "conv3_2": 12, "conv3_3": 14, "conv3_4": 16,
    "conv4_1": 19, "conv4_2": 21, "conv4_3": 23, "conv4_4": 25,
    "conv5_1": 28,
}

# Keras applications VGG19 layer names (kernels already HWIO)
_KERAS_NAMES = {
    "conv1_1": "block1_conv1", "conv1_2": "block1_conv2",
    "conv2_1": "block2_conv1", "conv2_2": "block2_conv2",
    "conv3_1": "block3_conv1", "conv3_2": "block3_conv2",
    "conv3_3": "block3_conv3", "conv3_4": "block3_conv4",
    "conv4_1": "block4_conv1", "conv4_2": "block4_conv2",
    "conv4_3": "block4_conv3", "conv4_4": "block4_conv4",
    "conv5_1": "block5_conv1",
}

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


def _load_torch_pth(path: str) -> NpParams:
    """A torchvision VGG19 state dict (or a module holding one): OIHW ->
    HWIO numpy. Classifier entries are ignored."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    params: NpParams = {}
    for name, idx in _TORCHVISION_INDICES.items():
        w = state[f"features.{idx}.weight"].numpy()  # (O, I, H, W)
        b = state[f"features.{idx}.bias"].numpy()
        params[name] = {
            "w": np.transpose(w, (2, 3, 1, 0)).astype(np.float32),  # HWIO
            "b": b.astype(np.float32),
        }
    return params


def _load_keras_h5(path: str) -> NpParams:
    """A Keras applications VGG19 file: weights-only (<layer>/<layer>/
    kernel:0), a full-model save (under 'model_weights') or Keras 3's
    flat layout (no ':0' suffix)."""
    import h5py

    params: NpParams = {}
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        for name, kname in _KERAS_NAMES.items():
            grp = root[kname]
            while not any(k.endswith("kernel:0") or k == "kernel"
                          for k in grp.keys()):
                grp = grp[list(grp.keys())[0]]
            kernel_key = "kernel:0" if "kernel:0" in grp else "kernel"
            bias_key = "bias:0" if "bias:0" in grp else "bias"
            params[name] = {
                "w": np.asarray(grp[kernel_key], dtype=np.float32),  # HWIO
                "b": np.asarray(grp[bias_key], dtype=np.float32),
            }
    return params


def _validate(params: NpParams) -> NpParams:
    shapes = param_shapes()
    for name in CONV_NAMES:
        got_w = tuple(params[name]["w"].shape)
        want_w = shapes[name]["w"]
        if got_w != want_w:
            raise ValueError(f"{name}: kernel shape {got_w} != expected {want_w}")
    return params


def _load_file(path: str) -> NpParams:
    if path.endswith(".npz"):
        return _validate(_load_npz(path))
    if path.endswith((".pth", ".pt")):
        return _validate(_load_torch_pth(path))
    if path.endswith((".h5", ".hdf5")):
        return _validate(_load_keras_h5(path))
    raise ValueError(f"Unknown weight format: {path}")


def load_vgg19_params(path: Optional[str] = None, seed: int = 0,
                      cache: bool = True) -> NpParams:
    """Resolve VGG19 weights (see the module docstring for the order).
    cache=False only keeps a named file from being written to the cache."""
    env = os.environ.get(_ENV_VAR)
    candidates = [c for c in (path, env) if c]
    if os.path.exists(_CACHE_FILE):
        candidates.append(_CACHE_FILE)
    for cand in candidates:
        named = cand in (path, env)
        if named and not os.path.exists(cand):
            # a path named explicitly must fail loudly: falling through
            # could end at the seeded weights, and a server stylizing with
            # those after a typo is worse than one that refuses to start
            raise FileNotFoundError(f"VGG19 weights not found: {cand}")
        try:
            params = _load_file(cand)
        except FileNotFoundError:
            if named:
                raise
            # a stale cache entry (gone since it was listed) falls through
            # the resolution order instead of aborting it
            print(f"warning: VGG19 weights candidate {cand} does not "
                  "exist; trying the next source", file=sys.stderr)
            continue
        if cache and cand != _CACHE_FILE:
            try:
                save_vgg19_params(params, _CACHE_FILE)
            except OSError as e:
                print(f"warning: could not cache VGG19 weights at "
                      f"{_CACHE_FILE}: {e}", file=sys.stderr)
        return params
    return init_vgg19_params(seed=seed)


def convert_weights_main(argv=None) -> int:
    """Convert torchvision ``.pth`` / Keras ``.h5`` VGG19 weights to the
    native ``.npz`` format, and with --install also into the cache file
    that every run of either package resolves:

        python -m artstyletransfer_tpu_torch.models.weights \\
            vgg19-dcbb9e9d.pth -o vgg19.npz --install
    """
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m artstyletransfer_tpu_torch.models.weights")
    parser.add_argument("input", help="source weights (.pth/.pt/.h5/.npz)")
    parser.add_argument("-o", "--output", default=None,
                        help="output .npz path (default: <input>.npz)")
    parser.add_argument("--install", action="store_true",
                        help=f"also install into the cache ({_CACHE_FILE}) "
                             "so all runs resolve them automatically")
    args = parser.parse_args(argv)

    params = load_vgg19_params(args.input, cache=False)
    out = args.output or os.path.splitext(args.input)[0] + ".npz"
    save_vgg19_params(params, out)
    n = sum(int(np.prod(v["w"].shape)) + int(np.prod(v["b"].shape))
            for v in params.values())
    print(f"wrote {out} ({len(params)} conv layers, {n:,} parameters)")
    if args.install:
        save_vgg19_params(params, _CACHE_FILE)
        print(f"installed -> {_CACHE_FILE}")
    return 0


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
    the seed and the file load_vgg19_params would read: the one the
    environment names, else the cache file (its path and modification
    time; the cache is written only when a named file is read). The
    captured evaluations (engine/graphs.py) bind the weights' tensors, so
    jobs share a graph only when they share these. The last 4 sources are
    kept."""
    dev = str(torch.device(device))
    if np_params is None:
        path = os.environ.get(_ENV_VAR) or _CACHE_FILE
        stamp = os.stat(path).st_mtime_ns if os.path.exists(path) else None
        key = ("seed", seed, path, stamp, dev)
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


if __name__ == "__main__":
    sys.exit(convert_weights_main())
