"""The inputs a run makes from its seed: weights and images.

The weights are VGG19's through conv5_1, He-normal (std sqrt(2 / (9
c_in))) with zero biases, drawn on the card by one ``torch.Generator`` in
one call and split into the layers; the program gets them in its weight
format (HWIO arrays), and the reference reads the same arrays. The images
are ``chip_smoke.py``'s ``synthetic_pair`` (smooth colour fields plus
texture for the content, noisy stripes for the style), one pair per job
from a seed drawn from the run's seed and the job's place in the traffic.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

CONVS = (("conv1_1", 3, 64), ("conv1_2", 64, 64),
         ("conv2_1", 64, 128), ("conv2_2", 128, 128),
         ("conv3_1", 128, 256), ("conv3_2", 256, 256),
         ("conv3_3", 256, 256), ("conv3_4", 256, 256),
         ("conv4_1", 256, 512), ("conv4_2", 512, 512),
         ("conv4_3", 512, 512), ("conv4_4", 512, 512),
         ("conv5_1", 512, 512))


def weights(seed: int, device) -> Dict[str, Dict[str, np.ndarray]]:
    """{conv: {'w': (3, 3, cin, cout) float32, 'b': (cout,)}} from `seed`."""
    import torch

    sizes = [9 * cin * cout for _, cin, cout in CONVS]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for (name, cin, cout), n in zip(CONVS, sizes):
        w = flat[at:at + n].view(3, 3, cin, cout) * float(
            np.sqrt(2.0 / (9 * cin)))
        out[name] = {"w": w.cpu().numpy(),
                     "b": np.zeros((cout,), np.float32)}
        at += n
    return out


def synthetic_pair(seed: int = 0, size: int = 512
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded content/style images in [0, 1] (chip_smoke.py's)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    content = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (k + 1) * xx + k)
                        * np.cos(2 * np.pi * (3 - k) * yy) for k in range(3)],
                       axis=-1)
    content += 0.05 * rng.standard_normal(content.shape)
    stripes = 0.5 + 0.5 * np.sin(40 * np.pi * (xx + yy))
    style = np.stack([stripes, 1 - stripes, 0.5 * stripes], axis=-1)
    style += 0.1 * rng.random(style.shape)
    return (np.clip(content, 0, 1).astype(np.float32),
            np.clip(style, 0, 1).astype(np.float32))


def job_seed(seed: int, index: int) -> int:
    """The image seed of the traffic's index-th job."""
    return int(np.random.SeedSequence([int(seed), int(index)])
               .generate_state(1, np.uint64)[0])


def job_images(seed: int, index: int, content_side: int,
               style_side: int) -> Tuple[np.ndarray, np.ndarray]:
    """(content, style) of one job: a content_side square content and a
    style_side square style, from one seed."""
    s = job_seed(seed, index)
    content = synthetic_pair(s, content_side)[0]
    style = synthetic_pair(s, style_side)[1]
    return content, style
