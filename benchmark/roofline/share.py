"""A layer's roofline share from the traced window: the least time its
work of every traced round could take on the card (``peaks.bound_s``)
over the device time its kernels took, summed over the ranks."""

from __future__ import annotations

from typing import Callable, Optional

from .peaks import bound_s


def roofline_pct(ctx, layer: str, round_work: Callable) -> Optional[float]:
    if not ctx.summaries or not ctx.card or not ctx.card["int_ops_per_s"]:
        return None
    spent = sum(s["layers"].get(layer, 0.0) for s in ctx.summaries)
    if spent <= 0:
        return None
    ops, nbytes = round_work(ctx.shape)
    least = (bound_s(nbytes, ops, ctx.card["int_ops_per_s"]) * ctx.rounds
             * len(ctx.summaries))
    return 100.0 * least / spent if least > 0 else None
