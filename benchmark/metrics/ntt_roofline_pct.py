"""The NTT layer's share of its roofline: the work of ``roofline/ntt.py``
over the device time of every kernel launched in ``fft``."""

from benchmark.roofline import ntt
from benchmark.roofline.share import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "ntt", ntt.round_work)
