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
counted), so a run can show that its path went through the kernels. A
wrapper called while its stream is being captured into a CUDA graph
(engine/graphs.py) launches nothing yet: its count goes to that capture's
record instead, and each replay of the graph adds the record to LAUNCHES
(``add_launches``).
"""

from __future__ import annotations

from typing import Dict

LAUNCHES = {"gram": 0, "gram_bwd": 0, "tv": 0, "tv_bwd": 0, "conv_relu": 0}

# capturing stream (its cudaStream_t as an int) -> the launches recorded
# into its graph so far
RECORDING: Dict[int, Dict[str, int]] = {}


def launched(name: str, stream: int) -> None:
    """Count one launch of kernel `name` on `stream`: in LAUNCHES, or in
    the record of the capture running on that stream."""
    counts = RECORDING.get(stream, LAUNCHES)
    counts[name] = counts.get(name, 0) + 1


def add_launches(counts: Dict[str, int]) -> None:
    """Add a captured graph's launches to LAUNCHES (one replay)."""
    for name, n in counts.items():
        LAUNCHES[name] += n


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
