"""Rows per second: every row of every completed round (each committed,
opened and folded into the aggregated proof) over the time from the first
round's start to the last round's end, on the host's clock."""


def read(ctx):
    if not ctx.times:
        return None
    span = ctx.times[-1][1] - ctx.times[0][0]
    return ctx.rounds * ctx.rows_per_round / span
