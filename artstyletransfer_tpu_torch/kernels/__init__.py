"""Hand-written Hopper kernels of the port and their plain PyTorch twins.

One module per TPU kernel family of ``artstyletransfer_tpu/ops/
pallas_kernels.py``: ``gram`` (``_gram_kernel`` and ``_gram_bwd_kernel``),
``tv`` (``_tv_kernel`` forward, and as ``tv_bwd`` the backward that the
JAX package leaves to XLA) and ``conv_relu`` (``_conv_relu_kernel``). Each
wrapper runs its kernel for a CUDA tensor, its plain version for a CPU
tensor, and raises for anything else; nothing falls back from the kernel
to the plain version. The Gram and TV kernels take a leading lane axis and
serve every lane of a batch in one launch.

LAUNCHES counts, per kernel, the wrapper calls that launched it (plain
runs are not counted), so a run can show that its path went through the
kernels.
"""

from __future__ import annotations

LAUNCHES = {"gram": 0, "gram_bwd": 0, "tv": 0, "tv_bwd": 0, "conv_relu": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
