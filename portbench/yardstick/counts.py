"""Operations and bytes of one loss evaluation, from the shapes alone.

One evaluation is VGG19 through conv5_1 at every pyramid level, forward
and the input-gradient backward (the weights take no gradient), with the
Gram, content and TV losses. Counted:

- each 3x3 convolution: 2 * h * w * 9 * c_in * c_out operations forward
  and as many for its input gradient; bytes: input, weights and output
  forward, output gradient, weights and input gradient backward, each
  read or written once (float32);
- each style tap's Gram: n * c * (c + 1) operations forward (G is
  symmetric: its upper triangle, as ``chip_smoke.py`` counts it), 2 * n *
  c^2 backward; bytes: F read and G written forward, F and G's gradient
  read and dF written backward.

Left out, so that a share of a peak can only read low: pooling, ReLU,
the content and TV losses and the pyramid's resize (element-wise work,
about 1e-4 of the operations), and the targets each job computes once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

CONV_PLAN = (("conv1_1", 3, 64, 0), ("conv1_2", 64, 64, 0),
             ("conv2_1", 64, 128, 1), ("conv2_2", 128, 128, 1),
             ("conv3_1", 128, 256, 2), ("conv3_2", 256, 256, 2),
             ("conv3_3", 256, 256, 2), ("conv3_4", 256, 256, 2),
             ("conv4_1", 256, 512, 3), ("conv4_2", 512, 512, 3),
             ("conv4_3", 512, 512, 3), ("conv4_4", 512, 512, 3),
             ("conv5_1", 512, 512, 4))
# the style taps: (conv whose ReLU output is the tap, channels, pools above)
STYLE_TAPS = (("conv1_1", 64, 0), ("conv2_1", 128, 1), ("conv3_1", 256, 2),
              ("conv4_1", 512, 3), ("conv5_1", 512, 4))
F32 = 4


def level_shapes(levels: int, base: int, aspect: float = 1.0
                 ) -> List[Tuple[int, int]]:
    """(h, w) of each pyramid level, the top (largest) first."""
    out = []
    for lvl in range(levels - 1, -1, -1):
        short = base * 2 ** lvl
        if aspect >= 1.0:
            out.append((short, int(round(short * aspect))))
        else:
            out.append((int(round(short / aspect)), short))
    return out


def _pooled(n: int, pools: int) -> int:
    for _ in range(pools):
        n //= 2
    return n


def conv_calls(h: int, w: int) -> List[Dict[str, float]]:
    """Each convolution of one forward at (h, w): its operations and its
    forward and input-gradient bytes."""
    out = []
    for name, cin, cout, pools in CONV_PLAN:
        hh, ww = _pooled(h, pools), _pooled(w, pools)
        ops = 2.0 * hh * ww * 9 * cin * cout
        wbytes = 9 * cin * cout * F32
        out.append({"name": name, "ops": ops,
                    "fwd_bytes": (hh * ww * (cin + cout)) * F32 + wbytes,
                    "bwd_bytes": (hh * ww * (cin + cout)) * F32 + wbytes})
    return out


def gram_calls(h: int, w: int) -> List[Dict[str, float]]:
    """Each style tap's Gram at (h, w): forward and backward operations
    and bytes."""
    out = []
    for name, c, pools in STYLE_TAPS:
        n = _pooled(h, pools) * _pooled(w, pools)
        out.append({"name": name,
                    "fwd_ops": float(n * c * (c + 1)),
                    "fwd_bytes": float((n * c + c * c) * F32),
                    "bwd_ops": float(2 * n * c * c),
                    "bwd_bytes": float((2 * n * c + c * c) * F32)})
    return out


def conv_forward_ops(h: int, w: int) -> float:
    return sum(c["ops"] for c in conv_calls(h, w))


def evaluation(fields: Dict) -> Dict[str, object]:
    """One lane's evaluation at the configuration's shapes: every conv
    call (forward and input gradient) and Gram call (forward and
    backward), and the operations in all."""
    shapes = level_shapes(int(fields["levels_num"]),
                          int(fields["base_diameter"]))
    convs, grams = [], []
    for h, w in shapes:
        for c in conv_calls(h, w):
            convs.append((c["ops"], c["fwd_bytes"]))
            convs.append((c["ops"], c["bwd_bytes"]))
        for g in gram_calls(h, w):
            grams.append((g["fwd_ops"], g["fwd_bytes"]))
            grams.append((g["bwd_ops"], g["bwd_bytes"]))
    return {"levels": shapes, "conv_calls": convs, "gram_calls": grams,
            "ops": sum(o for o, _ in convs) + sum(o for o, _ in grams)}


def least_seconds(calls, peak_ops: float, bytes_per_s: float) -> float:
    """The least time of calls [(ops, bytes)], each bounded by the larger
    of its operations over the peak and its bytes over the bandwidth."""
    return sum(max(ops / peak_ops, nbytes / bytes_per_s)
               for ops, nbytes in calls)
