"""Device meshes: where the jobs of a batch run.

The port of the JAX package's ``parallel/mesh.py``. There a mesh is a
``jax.sharding.Mesh`` and XLA places a batch's lanes over its 'jobs' axis
(and one job's pixels over its 'space' axis). Here a mesh is a small value
object: a tuple of indexed ``torch.device``s laid out row-major over
``axis_names`` ('jobs',) or ('jobs', 'space'), and a ``shape`` dict, so
that ``mesh.shape["jobs"]`` reads as it does in the JAX package.

A batch on a mesh whose jobs axis is A splits its lanes into A contiguous
shards, one per jobs row; each shard is a one-card batch with its own
captured graph, stepped by a host thread of its own (parallel/shards.py).
Jobs are independent, so the jobs axis carries no collective and needs no
``torch.distributed``. The space axis splits one job's pixels by rows over
the S devices of a jobs row when a batch is asked to (shard_space;
parallel/space.py): that row's shard thread drives its S devices, and one
autograd graph spans them, so it needs no ``torch.distributed`` either.
Without shard_space each jobs row runs on its first device.

A mesh may name one device twice. The CPU tests build ``[cpu, cpu]`` (the
CPU is one device, where the JAX tests use eight virtual ones), and
``jobs_mesh(devices=["cuda:0", "cuda:0"])`` rehearses the sharded path on
one card. The default meshes use distinct cards only.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..config import resolve_device


class Mesh:
    """Devices laid out over named axes. devices: row-major over
    axis_names; shape: {axis name: size}."""

    def __init__(self, devices: Sequence, axis_names: Tuple[str, ...],
                 sizes: Tuple[int, ...]):
        self.devices = tuple(_check_devices(devices))
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))
        if len(self.devices) != _prod(sizes) or len(sizes) != len(axis_names):
            raise ValueError(f"{len(self.devices)} devices do not fill the "
                             f"axes {self.shape}")

    @property
    def size(self) -> int:
        return len(self.devices)

    def jobs_devices(self) -> Tuple[torch.device, ...]:
        """The first device of each jobs row: where that row's shard of a
        batch runs."""
        return self.devices[::self.shape.get("space", 1)]

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.devices)
        return f"Mesh({self.shape}, [{devs}])"


def _prod(sizes) -> int:
    out = 1
    for s in sizes:
        out *= s
    return out


def _check_devices(devices) -> list:
    """torch.devices of one type; CUDA ones with an explicit visible
    index (a bare 'cuda' would mean each thread's current device)."""
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in out}) > 1:
        raise ValueError("a mesh mixes device types: "
                         + ", ".join(str(d) for d in out))
    if out[0].type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device {out[0]}")
    if out[0].type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        for d in out:
            if d.index is None:
                raise ValueError("a CUDA device on a mesh needs an index "
                                 "(cuda:N)")
            if d.index >= n:
                raise ValueError(f"{d} is not visible ({n} card(s))")
    return out


def _visible_cards() -> list:
    """cuda:0 .. cuda:N-1; raises where no card is visible."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA card is visible; a mesh on the CPU "
                           "takes explicit devices=[...]")
    return [torch.device("cuda", i) for i in range(n)]


def jobs_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over independent jobs: `devices`, else the first
    n_devices visible cards (every card when None)."""
    if devices is None:
        cards = _visible_cards()
        if n_devices is not None and n_devices > len(cards):
            raise ValueError(f"jobs_mesh({n_devices}): only {len(cards)} "
                             "card(s) visible")
        devices = cards[:n_devices] if n_devices else cards
    devices = list(devices)
    return Mesh(devices, ("jobs",), (len(devices),))


def jobs_space_mesh(n_jobs: int, n_space: int,
                    devices: Optional[Sequence] = None) -> Mesh:
    """2-D mesh: the jobs axis by the space axis."""
    if devices is None:
        devices = _visible_cards()
    need = n_jobs * n_space
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh(list(devices)[:need], ("jobs", "space"), (n_jobs, n_space))


def multislice_jobs_space_mesh(n_space: int = 1,
                               slice_devices: Optional[
                                   Sequence[Sequence]] = None) -> Mesh:
    """('jobs', 'space') mesh over several slices: each slice's devices form
    whole rows of n_space, and the rows of successive slices stack along
    'jobs', so a space group never straddles two slices (the JAX
    package's placement rule for TPU slices joined by the slower DCN).
    On one host every visible card is one slice; slice_devices lists the
    groups explicitly."""
    if slice_devices is None:
        slice_devices = [_visible_cards()]
    if n_space < 1:
        raise ValueError(f"n_space must be >= 1, got {n_space}")
    rows = []
    for i, devs in enumerate(slice_devices):
        devs = list(devs)
        if not devs or len(devs) % n_space:
            raise ValueError(
                f"slice {i} has {len(devs)} devices, not a non-zero "
                f"multiple of n_space={n_space}; a space group must not "
                f"straddle two slices")
        rows.extend(devs)
    return Mesh(rows, ("jobs", "space"), (len(rows) // n_space, n_space))


def default_serving_mesh(n_space: int = 1) -> Optional[Mesh]:
    """The mesh the serving frontends (queue_cli, the lab, the bot) use
    when none is given: every visible card, as a ('jobs', 'space') mesh,
    so that a host with several cards uses them all without flags. None
    where fewer than two cards are visible (the CPU included): a batch
    with no mesh runs on one card without shard threads.

    Gated by ASTT_SERVING_MESH: 'auto' (default) as above; 'none' turns
    the frontends' mesh off (the test suite sets it)."""
    mode = os.environ.get("ASTT_SERVING_MESH", "auto").lower()
    if mode in ("none", "off", "0"):
        return None
    if mode != "auto":
        raise ValueError(
            f"ASTT_SERVING_MESH must be 'auto' or 'none', got {mode!r}")
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        return None
    return multislice_jobs_space_mesh(n_space)


def serving_mesh(device, n_space: int = 1) -> Optional[Mesh]:
    """default_serving_mesh(n_space) for a frontend that serves on
    `device`: None when it serves on the CPU."""
    return (default_serving_mesh(n_space)
            if torch.device(device).type == "cuda" else None)


def jobs_axis(mesh) -> int:
    """The size of mesh's jobs axis (1 without a mesh)."""
    return mesh.shape.get("jobs", 1) if mesh is not None else 1


def check_mesh(mesh) -> None:
    """Raise unless `mesh` is None or a Mesh."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh or None, got "
                        f"{type(mesh).__name__}")


def placement(mesh, device=None) -> torch.device:
    """The device an entry point runs on: `device` resolved as
    config.resolve_device does without a mesh, else the mesh's first
    jobs device. A device of another type than the mesh's raises."""
    if mesh is None:
        return resolve_device(device)
    first = mesh.jobs_devices()[0]
    if device is not None and torch.device(device).type != first.type:
        raise ValueError(f"device={device!r} is not the type of the mesh's "
                         f"devices ({first.type})")
    return first
