"""The one peak table: NVIDIA H100 SXM data sheet, dense rates.

Every roofline share and ``step_mfu`` is taken against the highest dense rate
that any implementation of the configuration's stated precision could
use, so that no faster kernel can read over 100%: float32 and TF32 work
(a float32 product splits exactly over TF32 tensor cores) against 495
TFLOP/s, bfloat16 work against 989. The rates assume the card's full 700
W; each run prints the card's power limit beside its numbers.
"""

from __future__ import annotations

H100_SXM = {
    "source": "NVIDIA H100 Tensor Core GPU data sheet, SXM, dense",
    "power_limit_w": 700.0,
    "tf32_ops_per_s": 495e12,
    "bf16_ops_per_s": 989e12,
    "f32_cuda_core_ops_per_s": 67e12,
    "hbm_bytes_per_s": 3.35e12,
    "hbm_bytes": 80e9,
}


def peak_ops(fields: dict, table: dict = H100_SXM) -> float:
    """The operations peak for a configuration's compute dtype."""
    if fields.get("compute_dtype", "float32") == "bfloat16":
        return table["bf16_ops_per_s"]
    return table["tf32_ops_per_s"]


def hbm_bytes_per_s(table: dict = H100_SXM) -> float:
    return table["hbm_bytes_per_s"]
