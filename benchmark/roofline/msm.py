"""The MSM layer's work in one round, whatever the method.

Every MSM of the round is counted as Pippenger's bucket method over its N
points and its scalars' bit length b, at the window width c that needs the
fewest point operations: ceil(b / c) windows of N bucket adds, a running
sum of 2 (2^c - 1) adds and one add into the total, and b - c doubles.
Methods that need less are not counted: GLV (half the windows),
batch-affine adds (a cheaper add), signed digits (half the buckets), and a
fixed base's precomputed table (the aggregation's keys). The scalars are
uniform elements of Fr, so b is r's 255 bits. Bytes: every point and
scalar read once, every result written once.

A round of one rank, for each of its Bl challenges: each of its workers'
commitment and opening, two MSMs of T points over the worker's bases;
and, replicated on every rank of the challenge, the aggregation's C_y and
W_y (two MSMs over the M keys) and its C and W (two sums of M points,
M - 1 adds each). The bases and the keys are read once for all Bl.
"""

from __future__ import annotations

from .peaks import FR_BYTES, G1_BYTES, OPS_G1_ADD, OPS_G1_DOUBLE

SCALAR_BITS = 255


def pippenger_ops(n: int, bits: int = SCALAR_BITS) -> int:
    """Integer operations of one MSM of n points at the best window."""
    best = None
    for c in range(1, 25):
        windows = -(-bits // c)
        adds = windows * (n + 2 * ((1 << c) - 1) + 1)
        ops = adds * OPS_G1_ADD + max(bits - c, 0) * OPS_G1_DOUBLE
        best = ops if best is None else min(best, ops)
    return best


def round_work(shape: dict) -> tuple:
    """(operations, bytes) of one round on one rank."""
    rows, t, m = shape["rows_local"], shape["row"], shape["workers"]
    bl = shape.get("batch", 1)
    ops = bl * (2 * rows * pippenger_ops(t) + 2 * pippenger_ops(m)
                + 2 * (m - 1) * OPS_G1_ADD)
    nbytes = (rows * t * G1_BYTES + m * G1_BYTES
              + bl * (2 * rows * (t * FR_BYTES + G1_BYTES)
                      + 2 * (m * FR_BYTES + G1_BYTES)
                      + 2 * (m + 1) * G1_BYTES))
    return ops, nbytes
