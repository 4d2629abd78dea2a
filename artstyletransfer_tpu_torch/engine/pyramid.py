"""Input pyramid construction (host-side, one-time per job).

Reference parity: resize() aligns the shortest side of the image to
256 * 2^level with bicubic interpolation, preserving aspect ratio (reference
neural_style_transfer.py:211-226); content/style pyramids are built for
levels 0..levels_num-1 and stored HIGHEST-RESOLUTION FIRST (reference
neural_style_transfer.py:249-263, the insert(0, ...) pattern).

Uses the framework's own bicubic (ops/resize.py), which matches
cv2.INTER_CUBIC, so host pyramids and in-graph resizes share one kernel.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..ops.resize import bicubic_resize_np


def level_shape(h: int, w: int, level: int, base_diameter: int = 256) -> Tuple[int, int]:
    """Output (h, w) for a pyramid level (reference neural_style_transfer.py:213-224)."""
    if h >= w:
        base_width = base_diameter
        base_height = int(base_width * (h / w))
    else:
        base_height = base_diameter
        base_width = int(base_height * (w / h))
    return base_height * (2 ** level), base_width * (2 ** level)


MIN_LEVEL0_SIDE = 16  # below this, VGG19's relu5_1 tap (stride 16) is empty


def resize_to_level(img: np.ndarray, level: int, base_diameter: int = 256) -> np.ndarray:
    """Resize an HWC image so its shortest side is base_diameter * 2^level."""
    if base_diameter < MIN_LEVEL0_SIDE:
        raise ValueError(
            f"base_diameter must be >= {MIN_LEVEL0_SIDE} (VGG19 downsamples "
            f"16x; smaller level-0 images produce empty feature maps)")
    h, w = img.shape[:2]
    nh, nw = level_shape(h, w, level, base_diameter)
    return bicubic_resize_np(img.astype(np.float32), nh, nw)


def build_input_pyramids(content: np.ndarray, style: np.ndarray,
                         levels_num: int, base_diameter: int = 256
                         ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Build content/style pyramids, highest resolution first."""
    content_levels = [resize_to_level(content, lvl, base_diameter)
                      for lvl in range(levels_num - 1, -1, -1)]
    style_levels = [resize_to_level(style, lvl, base_diameter)
                    for lvl in range(levels_num - 1, -1, -1)]
    return content_levels, style_levels
