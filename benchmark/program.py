"""The reduction of one rank's profiler trace by the program's own spans.

The port marks the layers of its prove as ``record_function`` ranges named
``zkp.<span>`` (``zkp_subnet_tpu_torch/utils/trace.py``), nested as its
calls nest: ``fft``; ``prove`` holding ``commit_open`` (``open``, ``msm``,
and inside ``msm`` each ``bucket_runs``), ``gather`` and ``aggregate``.
This reads the same Chrome trace as ``trace.summarize``, inside the same
window, and leaves that reduction as it is:

- a device event (kernel, copy, set) goes to the innermost ``zkp.*`` span
  open at its launch's host time, found through its ``correlation``;
- each stretch of the window in which the card ran nothing is cut along
  the host's timeline, and each piece goes to the innermost ``zkp.*`` span
  open on the host then. A piece outside every ``zkp.*`` span keeps the
  label ``trace.summarize`` gives its whole gap (the benchmark's span open
  at the gap's start, or ``between_spans``).

No metric reads it yet: ``Rank.window`` keeps only ``trace.summarize``'s
reduction of the trace, so a metric of the program's spans needs that
method to keep this one beside it.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from . import trace as trace_mod

#: the program's spans are record_function ranges named PREFIX + span
PREFIX = "zkp."
#: launch calls: the CUDA runtime API's, and the CUDA driver API's (NCCL
#: may launch through ``cuLaunchKernelEx``)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NCCL = ("nccl", "Nccl")


def _innermost(spans: List[Tuple[float, float, str]]
               ) -> List[Tuple[float, float, str]]:
    """The host's timeline cut where the innermost open span changes:
    [(start, end, span)] in order, holding only times some span covers."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, str]] = []
    t = 0.0
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            out.append((t, end, top))
            t = max(t, end)
        if stack:
            out.append((t, s, stack[-1][1]))
        stack.append((e, name))
        t = s
    while stack:
        end, top = stack.pop()
        out.append((t, end, top))
        t = max(t, end)
    return [seg for seg in out if seg[1] > seg[0]]


class _Timeline:
    """The innermost program span at a host time, and along an
    interval."""

    def __init__(self, spans):
        self.segs = _innermost(spans)
        self.starts = [s for s, _, _ in self.segs]

    def at(self, ts: float) -> Optional[str]:
        k = bisect.bisect_right(self.starts, ts) - 1
        if k >= 0 and self.segs[k][1] >= ts:
            return self.segs[k][2]
        return None

    def split(self, a: float, b: float) -> List[Tuple[Optional[str], float]]:
        """[(span or None, µs)] covering [a, b) along the segments."""
        out = []
        k = max(bisect.bisect_right(self.starts, a) - 1, 0)
        edge = a
        while edge < b and k < len(self.segs):
            s, e, name = self.segs[k]
            k += 1
            if e <= edge:
                continue
            if s >= b:
                break
            if s > edge:
                out.append((None, s - edge))
                edge = s
            t = min(e, b)
            out.append((name, t - edge))
            edge = t
        if edge < b:
            out.append((None, b - edge))
        return out


def summarize(events: List[dict]) -> Optional[dict]:
    """{spans {span: {device_s, idle_s, entered, nccl [s, ...]}}, idle
    {label: s}} of the traced window, or None where the trace has no
    window. ``idle`` labels a piece by ``zkp.<span>``, or outside every
    program span by ``trace.summarize``'s label of its gap; ``nccl`` holds
    every NCCL kernel's time in the order the kernels started."""
    windows = [e for e in events if e.get("name") == trace_mod.WINDOW
               and "dur" in e and e.get("cat") == "user_annotation"]
    if not windows:
        return None
    w0 = windows[0]["ts"]
    w1 = w0 + windows[0]["dur"]
    found = [(e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):])
             for e in events
             if e.get("cat") == "user_annotation" and "dur" in e
             and e.get("name", "").startswith(PREFIX)]
    program = _Timeline(found)
    bench = trace_mod._Spans(events)
    spans: Dict[str, dict] = {}

    def entry(name: str) -> dict:
        return spans.setdefault(name, {"device_s": 0.0, "idle_s": 0.0,
                                       "entered": 0, "nccl": []})
    for s, _, name in found:
        if w0 <= s < w1:
            entry(name)["entered"] += 1
    launch_ts = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = e["ts"]
    busy: List[Tuple[float, float]] = []
    nccl: Dict[str, List[Tuple[float, float]]] = {}
    for e in events:
        if e.get("cat") not in trace_mod.DEVICE_CATS or "dur" not in e:
            continue
        s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t <= s:
            continue
        busy.append((s, t))
        corr = e.get("args", {}).get("correlation")
        name = program.at(launch_ts[corr]) if corr in launch_ts else None
        if name is None:
            continue
        entry(name)["device_s"] += (t - s) * 1e-6
        if any(k in e.get("name", "") for k in NCCL):
            nccl.setdefault(name, []).append((s, (t - s) * 1e-6))
    for name, times in nccl.items():
        entry(name)["nccl"] = [sec for _, sec in sorted(times)]
    idle: Dict[str, float] = {}
    edge = w0
    for s, t in trace_mod._union(busy) + [[w1, w1]]:
        if s > edge:
            gap = bench.at(edge) or "between_spans"
            for name, us in program.split(edge, s):
                label = gap if name is None else PREFIX + name
                idle[label] = idle.get(label, 0.0) + us * 1e-6
                if name is not None:
                    entry(name)["idle_s"] += us * 1e-6
        edge = max(edge, t)
    return {"spans": spans, "idle": idle}

