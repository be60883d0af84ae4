"""The share of the traced window in which no kernel, copy or set ran on
the card, averaged over the ranks."""


def read(ctx):
    if not ctx.summaries:
        return None
    shares = [100.0 * (1.0 - s["busy_s"] / s["window_s"])
              for s in ctx.summaries if s["window_s"] > 0 and s["kernels"]]
    return sum(shares) / len(shares) if shares else None
