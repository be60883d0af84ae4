"""The MSM layer's share of its roofline: the work of ``roofline/msm.py``
over the device time of the MSM kernels launched in ``prove``."""

from benchmark.roofline import msm
from benchmark.roofline.share import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "msm", msm.round_work)
