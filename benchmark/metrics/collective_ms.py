"""Device ms a round of the collectives' (NCCL) kernels: for each
collective, the least time any rank's kernel took, summed. A collective's
kernel waits on each rank for the last rank to arrive, whose kernel waits
least, so its time is the closest to the transfer itself; a mean over the
ranks would read their skew. Where the ranks' traces do not hold the same
number of collectives, the least rank's total."""


def read(ctx):
    if not ctx.summaries or not ctx.rounds:
        return None
    seqs = [s["each"].get("collective", []) for s in ctx.summaries]
    if not any(seqs):
        return None
    if len({len(q) for q in seqs}) == 1:
        spent = sum(min(times) for times in zip(*seqs))
    else:
        spent = min(s["layers"].get("collective", 0.0)
                    for s in ctx.summaries)
    return 1e3 * spent / ctx.rounds
