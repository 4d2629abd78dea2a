"""Checkpoint / resume of an in-flight optimization.

The port of the JAX package's ``engine/checkpoint.py``: the whole state of
a job or a batch — the image vector (NHWC flatten order), the optimizer
state and the step counter — round-trips through one ``.npz`` file, so a
run resumes exactly where it stopped (bit for bit on one device).
A batch sharded over a mesh (its lanes over the jobs axis, its pixels over
the space axis) writes the same file, its leaves gathered in lane and
pixel order, and resumes from a file written without the mesh, and the
reverse.

The container and its keys are the JAX package's: ``magic``
(``astt-checkpoint-v1``), ``step``, ``x``, ``fingerprint``, ``extra_json``,
``opt_*``, ``aux_*`` and ``ext_dtypes_json``. The optimizer state is a dict
of named leaves (``opt_<name>``), not the JAX package's ``opt_leaf_<i>``
tree order, so a JAX-written file does not resume here. numpy has no
bfloat16: such tensors are stored as a uint16 view plus the dtype's name
in ``ext_dtypes_json``, which the JAX package decodes the same way.

A checkpoint carries the engine config's FINGERPRINT and each leaf's shape
and dtype: a load under another config, or into a state of another shape,
raises ValueError naming the difference instead of silently mixing
states.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_MAGIC = "astt-checkpoint-v1"

# torch dtypes numpy cannot hold, stored as a uint16 view (the JAX
# package's _EXT_DTYPE_STORAGE)
_EXT_DTYPES = {torch.bfloat16: "bfloat16"}
_BY_NAME = {name: dt for dt, name in _EXT_DTYPES.items()}


def _encode(v) -> tuple:
    """-> (storable numpy array, real dtype name or None). A sharded
    batch's leaf (parallel/shards.py Lanes, parallel/space.py SpaceLanes)
    is gathered to the host first, in the unsharded layout."""
    if not torch.is_tensor(v) and hasattr(v, "cpu"):
        v = v.cpu()
    if not torch.is_tensor(v):
        return np.asarray(v), None
    v = v.detach()
    name = _EXT_DTYPES.get(v.dtype)
    if name is None:
        return v.cpu().numpy(), None
    return v.view(torch.int16).cpu().numpy().view(np.uint16), name


def _decode(arr: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    if dtype_name is None:
        return torch.from_numpy(np.array(arr))
    if dtype_name not in _BY_NAME:
        raise ValueError(f"checkpoint leaf of unknown dtype {dtype_name!r}")
    return torch.from_numpy(np.array(arr).view(np.int16)).view(
        _BY_NAME[dtype_name])


def save_checkpoint(path: str, x, opt_state: Mapping[str, Any], step: int,
                    fingerprint: Optional[str] = None,
                    extra: Optional[Dict[str, Any]] = None,
                    aux: Optional[Mapping[str, Any]] = None) -> None:
    """Write x, the named optimizer leaves and the step to `path`,
    atomically (a `.tmp` file, then os.replace). Tensors may live on any
    device; they are copied to the host.

    extra: small JSON-serialisable host state (e.g. the stop_tol latch);
    aux: named host arrays (e.g. the frozen rows of lanes that left a
    shrinking batch), loaded back with with_aux=True."""
    arrays: Dict[str, np.ndarray] = {"magic": np.array(_MAGIC),
                                     "step": np.array(step)}
    ext_dtypes: Dict[str, str] = {}

    def put(key: str, v) -> None:
        arrays[key], name = _encode(v)
        if name is not None:
            ext_dtypes[key] = name

    put("x", x)
    if fingerprint is not None:
        arrays["fingerprint"] = np.array(fingerprint)
    if extra:
        arrays["extra_json"] = np.array(json.dumps(extra))
    for name, v in opt_state.items():
        put(f"opt_{name}", v)
    for name, v in (aux or {}).items():
        put(f"aux_{name}", v)
    if ext_dtypes:
        arrays["ext_dtypes_json"] = np.array(json.dumps(ext_dtypes))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)  # a crash never leaves a torn checkpoint


def _check_magic(data, path: str) -> None:
    if "magic" not in data or str(data["magic"]) != _MAGIC:
        raise ValueError(f"not an astt checkpoint: {path}")


def _extra(data) -> Dict[str, Any]:
    return json.loads(str(data["extra_json"])) if "extra_json" in data else {}


def peek_checkpoint_meta(path: str) -> tuple:
    """(step, extra) of a checkpoint without reading its state (npz
    members load lazily): a shrinking batch needs its lane composition
    before it can build the template for load_checkpoint."""
    with np.load(path, allow_pickle=False) as data:
        _check_magic(data, path)
        return int(data["step"]), _extra(data)


def load_checkpoint(path: str, template: Mapping[str, torch.Tensor],
                    fingerprint: Optional[str] = None,
                    with_extra: bool = False, with_aux: bool = False):
    """Returns (x, opt_state, step), plus extra with with_extra=True and
    aux with with_aux=True; x and every leaf are CPU tensors.

    template: {leaf name: a tensor of the expected shape and dtype} (meta
    tensors cost nothing). The file must hold exactly these leaves, each
    of that shape and dtype, and, when both the caller and the file carry
    a fingerprint, the same fingerprint; otherwise ValueError."""
    with np.load(path, allow_pickle=False) as data:
        _check_magic(data, path)
        ext = (json.loads(str(data["ext_dtypes_json"]))
               if "ext_dtypes_json" in data else {})
        if fingerprint is not None and "fingerprint" in data:
            saved = str(data["fingerprint"])
            if saved != fingerprint:
                raise ValueError(
                    f"checkpoint {path} was written under a different "
                    f"engine config and cannot resume this job.\n  saved:"
                    f"   {saved}\n  current: {fingerprint}\nDelete the "
                    f"checkpoint (or restore the original flags) to "
                    f"proceed.")
        saved_leaves = {k[len("opt_"):] for k in data.files
                        if k.startswith("opt_")}
        if saved_leaves != set(template):
            raise ValueError(
                f"checkpoint {path} holds optimizer leaves "
                f"{sorted(saved_leaves)}, expected {sorted(template)} "
                f"(different optimizer or config?)")
        opt_state = {}
        for name, want in template.items():
            key = f"opt_{name}"
            leaf = _decode(data[key], ext.get(key))
            if tuple(leaf.shape) != tuple(want.shape):
                raise ValueError(
                    f"checkpoint leaf {name!r} has shape "
                    f"{tuple(leaf.shape)}, expected {tuple(want.shape)} "
                    f"(different config/shape?)")
            if leaf.dtype != want.dtype:
                raise ValueError(
                    f"checkpoint leaf {name!r} has dtype {leaf.dtype}, "
                    f"expected {want.dtype} (different state dtype/config?)")
            opt_state[name] = leaf
        out = [_decode(data["x"], ext.get("x")), opt_state,
               int(data["step"])]
        if with_extra:
            out.append(_extra(data))
        if with_aux:
            out.append({k[len("aux_"):]: _decode(data[k], ext.get(k))
                        for k in data.files if k.startswith("aux_")})
    return tuple(out)
