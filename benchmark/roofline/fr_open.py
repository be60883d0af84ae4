"""The Fr pipeline's work in one round: every row of each of the rank's
challenges opened at alpha.

One Fr product and one Fr add a coefficient (synthetic division by
X - alpha gives the quotient and f(alpha) at once). Bytes: the
coefficients read once and the quotients written once. The aggregation's
few Fr operations (M differences inverted, sums over M) are not counted.
"""

from __future__ import annotations

from .peaks import FR_BYTES, OPS_FR_LIN, OPS_FR_MUL


def round_work(shape: dict) -> tuple:
    """(operations, bytes) of one round on one rank."""
    elems = shape.get("batch", 1) * shape["rows_local"] * shape["row"]
    return elems * (OPS_FR_MUL + OPS_FR_LIN), 2 * elems * FR_BYTES
