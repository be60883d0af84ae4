"""A run of one rank from set-up to (rank 0) the result line."""

from __future__ import annotations

import time
from typing import Optional

import torch

from . import judge as judge_mod
from . import trace as trace_mod
from .rank import Rank, reader_context


def run_rank(rank: Rank, t_start: Optional[float] = None) -> Optional[dict]:
    """Set up, measure, observe; on rank 0 also judge and read the
    metrics. Returns rank 0's result line (with the judge's counts under
    ``_bad`` and ``_seen``, and under ``_forbidden`` the forbidden modules
    each rank held after its window), None on other ranks."""
    rank.set_up()
    setup_s = time.perf_counter() - t_start if t_start is not None else None
    rank.window()
    obs = rank.observe()
    rank.free()
    everyone = rank.exchange(obs)
    if everyone is None:
        return None
    expected, reference = rank.expected(everyone)
    bad, seen, failed = judge_mod.judge(everyone, expected, reference)
    ctx = reader_context(rank, everyone, setup_s)
    metrics = {}
    for m in rank.spec.metrics(rank.cell, rank.trace):
        value = rank.spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if rank.dev.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(rank.dev)
                       if rank.dev.type == "cuda" else "cpu"),
              "count": rank.world, "memory_peak_bytes": ctx.peak}
    if ctx.card:
        device.update({k: v for k, v in ctx.card.items()
                       if k != "int_ops_per_s"})
    line = {"correct": judge_mod.correct(bad) and ctx.rounds > 0,
            "attempted": ctx.rounds, "failed": failed, "metrics": metrics,
            "device": device}
    if rank.trace and ctx.summaries:
        sums = ctx.summaries
        device["busy_s"] = sum(s["busy_s"] for s in sums) / len(sums)
        device["window_s"] = sum(s["window_s"] for s in sums) / len(sums)
        line["breakdown"] = {
            "device_ops": trace_mod.top(sums[0]["ops"]),
            "idle_gaps": trace_mod.top(sums[0]["gaps"])}
    line["checks"] = judge_mod.as_result(bad)
    line["_bad"], line["_seen"] = bad, seen
    line["_forbidden"] = ctx.forbidden
    return line
