"""The NTT layer's work in one round: the traffic's inverse NTTs of each
of the rank's challenges, ``x`` each of its Ml rows of T points, ``y``
its T / n columns of M points (n ranks on the machines axis).

A radix-2 transform of N points: its twiddle products other than 1,
(N/2) log N - (N - 1), the inverse's scaling by 1/N, N products, and its
N log N add/subtracts. Bytes: the input read once and the output written
once, however many transforms run.
"""

from __future__ import annotations

from .peaks import FR_BYTES, OPS_FR_LIN, OPS_FR_MUL


def transform_ops(n: int) -> int:
    """Integer operations of one inverse NTT of n points."""
    log_n = n.bit_length() - 1
    products = (n // 2) * log_n - (n - 1) + n
    return products * OPS_FR_MUL + n * log_n * OPS_FR_LIN


def round_work(shape: dict) -> tuple:
    """(operations, bytes) of one round on one rank."""
    rows, t, m = shape["rows_local"], shape["row"], shape["workers"]
    bl = shape.get("batch", 1)
    transforms = shape.get("transforms", ["x"])
    if not transforms:
        return 0, 0
    counts = {"x": (rows, t),
              "y": (t // shape.get("machine_ranks", 1), m)}
    ops = sum(bl * counts[a][0] * transform_ops(counts[a][1])
              for a in transforms)
    return ops, 2 * bl * rows * t * FR_BYTES
