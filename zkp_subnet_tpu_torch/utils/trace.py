"""Named ranges of the prove for torch.profiler.

``span(name)`` marks one layer of the prove (the NTT, the local commit and
opening, the MSM and its digit sort, the all-gather, the aggregation) as a
``record_function`` range named ``zkp.<name>``. The ranges land in the
profiler's trace on the clock of the CUDA kernels, copies and launch calls,
so every launch and every idle stretch of the card can be put down to the
innermost range open on the host at that time.

A range is recorded only while a profiler session records: otherwise
``span`` hands back one shared null context, and the prove pays one
boolean check a range (an idle ``record_function`` costs tens of times
more, on every call of the runtime).
"""

from __future__ import annotations

import contextlib

import torch

#: the prefix of every range's name in the trace
PREFIX = "zkp."

_OFF = contextlib.nullcontext()


def span(name: str):
    """``record_function("zkp." + name)`` while a profiler records, else
    the shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF
