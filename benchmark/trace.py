"""The reduction of one rank's profiler trace to what the per-layer
metrics read.

The trace is torch.profiler's Chrome trace (``export_chrome_trace``): host
events (the benchmark's own spans, ``record_function`` ranges named
``bench.<span>``, and the CUDA runtime's launch calls) and device events
(kernels, copies, sets), all in microseconds on one clock. A device event
is tied to its launch by the ``correlation`` of its ``args``, the launch
to the benchmark's span that was open on the host when it was made, and
(span, kernel name) to a layer by the rules of ``layers/<layer>.json``.
"""

from __future__ import annotations

import bisect
import json
import re
from typing import Dict, List, Optional, Tuple

#: the benchmark's spans are record_function ranges named PREFIX + span
PREFIX = "bench."
WINDOW = PREFIX + "window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime",)


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)",
                                              "anon"))
    depth = 0
    for k, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:k]
            break
    return name.strip()[:96]


def layer_of(span: Optional[str], kernel: str, rules: List[dict]) -> str:
    """The first rule's layer whose span (if it names one) and kernel
    substrings (if it lists any) match; else ``other``."""
    for rule in rules:
        if "span" in rule and rule["span"] != span:
            continue
        if "kernels" in rule and not any(k in kernel
                                         for k in rule["kernels"]):
            continue
        return rule["layer"]
    return "other"


def _union(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _Spans:
    """The benchmark's host spans, for the span open at a time."""

    def __init__(self, events):
        spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):])
                       for e in events
                       if e.get("name", "").startswith(PREFIX)
                       and e["name"] != WINDOW and "dur" in e
                       and e.get("cat") == "user_annotation")
        self.starts = [s[0] for s in spans]
        self.spans = spans

    def at(self, ts: float) -> Optional[str]:
        """The span open at host time ts (the spans never nest)."""
        k = bisect.bisect_right(self.starts, ts) - 1
        if k >= 0 and self.spans[k][1] >= ts:
            return self.spans[k][2]
        return None


def summarize(events: List[dict], rules: List[dict]) -> Optional[dict]:
    """{window_s, busy_s, layers {layer: s}, ops {kernel: s},
    gaps {host span: s}, kernels (count), each {layer: [s, ...]}} of the
    traced window, or None where the trace has no window. ``each`` holds,
    for the layers whose rules ask for it, every kernel's time in the
    order the kernels started."""
    windows = [e for e in events if e.get("name") == WINDOW and "dur" in e
               and e.get("cat") == "user_annotation"]
    if not windows:
        return None
    w0 = windows[0]["ts"]
    w1 = w0 + windows[0]["dur"]
    spans = _Spans(events)
    launch_ts = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = e["ts"]
    layers: Dict[str, float] = {}
    ops: Dict[str, float] = {}
    keep = {rule["layer"] for rule in rules if rule.get("each")}
    each: Dict[str, List[Tuple[float, float]]] = {}
    busy: List[Tuple[float, float]] = []
    count = 0
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t <= s:
            continue
        count += 1
        sec = (t - s) * 1e-6
        name = short_name(e.get("name", ""))
        corr = e.get("args", {}).get("correlation")
        span = spans.at(launch_ts[corr]) if corr in launch_ts else None
        layer = layer_of(span, name, rules)
        layers[layer] = layers.get(layer, 0.0) + sec
        ops[name] = ops.get(name, 0.0) + sec
        if layer in keep:
            each.setdefault(layer, []).append((s, sec))
        busy.append((s, t))
    merged = _union(busy)
    gaps: Dict[str, float] = {}
    edge = w0
    for s, t in merged + [[w1, w1]]:
        if s > edge:
            label = spans.at(edge) or "between_spans"
            gaps[label] = gaps.get(label, 0.0) + (s - edge) * 1e-6
        edge = max(edge, t)
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(t - s for s, t in merged) * 1e-6,
            "layers": layers, "ops": ops, "gaps": gaps, "kernels": count,
            "each": {layer: [sec for _, sec in sorted(times)]
                     for layer, times in each.items()}}


def load(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def top(table: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])
            [:n]]
