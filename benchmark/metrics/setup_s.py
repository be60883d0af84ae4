"""Set-up: process start to the first timed round (torch and CUDA, the
kernel library, SRS, mesh, pool, warm round), on the host's clock."""


def read(ctx):
    return ctx.setup_s
