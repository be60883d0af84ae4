"""The Fr pipeline's share of its roofline: the work of
``roofline/fr_open.py`` over the device time of the Fr kernels launched
in ``prove``."""

from benchmark.roofline import fr_open
from benchmark.roofline.share import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "fr_open", fr_open.round_work)
