"""Hand-written Hopper kernels of the port and their plain PyTorch twins.

One module per TPU kernel family of ``artstyletransfer_tpu/ops/
pallas_kernels.py``: ``gram`` (``_gram_kernel`` and ``_gram_bwd_kernel``),
``tv`` (``_tv_kernel`` forward, and as ``tv_bwd`` the backward that the
JAX package leaves to XLA) and ``conv_relu`` (``_conv_relu_kernel``). Each
wrapper runs its kernel for a CUDA tensor, its plain version for a CPU
tensor, and raises for anything else; nothing falls back from the kernel
to the plain version. The Gram and TV kernels take a leading lane axis and
serve every lane of a batch in one launch.

LAUNCHES counts, per kernel, the launches that ran (plain runs are not
counted), so a run can show that its path went through the kernels;
DEVICE_LAUNCHES holds the same counts per card (by CUDA device index), so
a run on a mesh can show that every card ran them. The counts are taken
under one lock: a mesh steps each card's shard from a thread of its own.
A wrapper called while its stream is being captured into a CUDA graph
(engine/graphs.py) launches nothing yet: its count goes to that capture's
record instead, and each replay of the graph adds the record to the counts
(``add_launches``).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

KERNELS = ("gram", "gram_bwd", "tv", "tv_bwd", "conv_relu")
LAUNCHES = dict.fromkeys(KERNELS, 0)
DEVICE_LAUNCHES: Dict[int, Dict[str, int]] = {}

# capturing stream (its cudaStream_t as an int) -> the launches recorded
# into its graph so far
RECORDING: Dict[int, Dict[str, int]] = {}

_lock = threading.Lock()


def _add(name: str, n: int, device: Optional[int]) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + n
    if device is not None:
        per = DEVICE_LAUNCHES.setdefault(device, dict.fromkeys(KERNELS, 0))
        per[name] = per.get(name, 0) + n


def launched(name: str, stream: int, device: Optional[int] = None) -> None:
    """Count one launch of kernel `name` on `stream` of CUDA device
    `device` (its index): in LAUNCHES and DEVICE_LAUNCHES, or in the
    record of the capture running on that stream."""
    with _lock:
        record = RECORDING.get(stream)
        if record is not None:
            record[name] = record.get(name, 0) + 1
        else:
            _add(name, 1, device)


def add_launches(counts: Dict[str, int],
                 device: Optional[int] = None) -> None:
    """Add a captured graph's launches (one replay on `device`)."""
    with _lock:
        for name, n in counts.items():
            _add(name, n, device)


def device_launches() -> Dict[int, Dict[str, int]]:
    """A copy of DEVICE_LAUNCHES."""
    with _lock:
        return {dev: dict(c) for dev, c in DEVICE_LAUNCHES.items()}


def reset_launches() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        DEVICE_LAUNCHES.clear()
