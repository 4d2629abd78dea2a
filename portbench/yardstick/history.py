"""The least bytes of one step's L-BFGS history work on the card.

The work is engine/lbfgs_card.py's accept graph, whose launch the
program's ``lbfgs.history`` span marks: for `lanes` lanes of row length
`n`, holding `pairs` pairs once it has stored (summed over the lanes),
the least the work needs, each row read as few times as the order of
its contractions allows:

- the products: one pass over the held Y rows for Y s, Y y and Y g, and
  one over the held S rows for S y and S g (all five exist once the pair
  is stored; two reads of the held rows);
- the combination of the S and Y rows by the two-loop coefficients, which
  wait for those products (two more);
- the store: the new s and y rows written, one each a lane;
- the lane vectors: x, d, the gradient and the accepted trial's gradient
  read, x, the gradient, d and the first trial point written (eight a
  lane, float32);
- the coefficients: P = S Yᵀ and Q = Y Yᵀ over the held pairs, and rho
  (with pairs spread evenly over the lanes, which can only count low).

History rows are in the history's dtype (4 bytes, 2 for bfloat16). Rows
not yet stored are not counted, though the graph's products run over
all of them: a step need not read them. The graph as it is makes seven
passes over the rows (three GEMVs for the Grams' refresh, S g and Y g,
the combination's two), so on this count it reaches at most 4/7 of the
roofline.
"""

from __future__ import annotations

ROW_READS = 4       # a pass each over Y and S: products, then the sum
PAIR_ROWS = 2       # s and y written
VECTOR_PASSES = 8   # 4 lane vectors read, 4 written
F32 = 4


def row_bytes(fields: dict) -> int:
    """Bytes of one stored history value."""
    return 2 if fields.get("lbfgs_state_dtype") == "bfloat16" else 4


def history_bytes(lanes: int, pairs: int, n: int, row: int = 4) -> float:
    """Least bytes of one accept graph: `lanes` lanes of `n` values holding
    `pairs` pairs in all, history values of `row` bytes."""
    per_lane = pairs / lanes
    return float(ROW_READS * pairs * n * row
                 + PAIR_ROWS * lanes * n * row
                 + VECTOR_PASSES * lanes * n * F32
                 + lanes * (2 * per_lane * per_lane + per_lane) * F32)
