"""Kernel launches a round: the change of the port's counter
``ops.kernels.LAUNCHES`` over the window, over the rounds (rank 0)."""


def read(ctx):
    if not ctx.rounds:
        return None
    return ctx.launches / ctx.rounds
