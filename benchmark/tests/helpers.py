"""A benchmark of toy cells for the CPU tests: its own ``BENCHMARK.json``,
configurations and traffic files in a temporary directory, the harness's
metric readers and layer rules."""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import sys
import time
import types

import torch

from benchmark import result
from benchmark.rank import Rank
from benchmark.spec import HERE, Spec

#: the toy cells: (config, scale, machines_scale, pool, ranks, and the
#: traffic's further keys)
CELLS = {"toy_6_2.prove": ("toy_6_2", 6, 2, 2, 1, {}),
         "toy_4_1.prove": ("toy_4_1", 4, 1, 2, 1, {}),
         "toy_4_1.prove2": ("toy_4_1", 4, 1, 2, 2, {}),
         "toy_6_2.prove4": ("toy_6_2", 6, 2, 2, 4, {}),
         "toy_4_1.batch2_xy": ("toy_4_1", 4, 1, 2, 1,
                               {"challenges_per_round": 2,
                                "transforms": ["x", "y"]}),
         "toy_6_2.y": ("toy_6_2", 6, 2, 2, 1, {"transforms": ["y"]}),
         "toy_4_1.y2": ("toy_4_1", 4, 1, 2, 2, {"transforms": ["y", "x"]}),
         "toy_4_1.batch_ranks2": ("toy_4_1", 4, 1, 2, 2,
                                  {"challenges_per_round": 2,
                                   "batch_ranks": 2})}


def make_root(tmp: str) -> str:
    """A checkout-like directory holding the toy benchmark."""
    with open(os.path.join(HERE, "..", "BENCHMARK.json")) as f:
        data = json.load(f)
    shutil.copytree(os.path.join(HERE, "metrics"),
                    os.path.join(tmp, "metrics"), dirs_exist_ok=True)
    shutil.copytree(os.path.join(HERE, "layers"),
                    os.path.join(tmp, "layers"), dirs_exist_ok=True)
    os.makedirs(os.path.join(tmp, "traffic"), exist_ok=True)
    configs, cells = {}, []
    for name, (cfg, scale, ms, pool, ranks, extra) in CELLS.items():
        path = os.path.join(tmp, cfg + ".json")
        with open(path, "w") as f:
            json.dump({"name": cfg, "scale": scale, "machines_scale": ms}, f)
        configs[cfg] = {"name": cfg, "source": "toy", "file": path,
                        "reduced": [], "why": "a test's size"}
        traffic = f"toy_{name.split('.')[1]}_pool{pool}_ranks{ranks}"
        with open(os.path.join(tmp, "traffic", traffic + ".json"), "w") as f:
            json.dump(dict({"pool": pool, "ranks": ranks,
                            "sampled_rounds": 1,
                            "srs_samples": {"g1_x": 8, "bases": 16,
                                            "lagrange_y": 4}}, **extra), f)
        cells.append({"name": name, "config": cfg, "traffic": traffic,
                      "chips": ranks, "why": "a test's size"})
    data["configs"] = list(configs.values())
    data["workloads"] = cells
    for m in data["end_to_end"] + data["per_layer"]:
        m.pop("workloads", None)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(data, f)
    return tmp


def spec_of(root: str) -> Spec:
    return Spec(root, bench_dir=root)


def run_cell(root: str, cell: str, seed: int, seconds: float = 0.0,
             trace: bool = False, rank: int = 0, world: int = 1,
             ports=None):
    """One rank of a run on the CPU, the harness's look for a card
    skipped: rank 0's result line, None on other ranks."""
    r = Rank(spec_of(root), cell, seed, seconds, trace, rank, world, ports,
             "cpu")
    try:
        return result.run_rank(r, time.perf_counter())
    finally:
        r.close()


# -- faults planted under the timed path ------------------------------------


def _par():
    from zkp_subnet_tpu_torch.parallel import pianist
    return pianist


def _stale(par):
    """A step that returns its state unchanged: every prove hands back the
    first proof it made."""
    prove, first = par.prove, []

    def fault(*args, **kwargs):
        if not first:
            first.append(prove(*args, **kwargs))
        return first[0]
    return "prove", fault


def _half(par):
    """Half of the batch left out: the second half of each rank's rows is
    neither committed nor opened, and the aggregate is taken over the
    rest."""
    from zkp_subnet_tpu_torch.ops.curve import g1_infinity
    commit_open = par.commit_open

    def fault(bases, rows, alpha):
        half = rows.shape[1] // 2 or 1
        com, ev, prf = commit_open(bases[:half].contiguous(),
                                   rows[:, :half].contiguous(), alpha)
        bl, ml = rows.shape[:2]
        pad = g1_infinity((bl, ml - half), rows.device)
        zeros = ev.new_zeros((bl, ml - half, ev.shape[-1]))
        return (torch.cat([com, pad], 1), torch.cat([ev, zeros], 1),
                torch.cat([prf, pad], 1))
    return "commit_open", fault


def _no_exchange(par):
    """The exchange between ranks left out: each rank aggregates its own
    pieces, repeated in the others' places."""
    def fault(mesh, parts, axes):
        n = mesh[par.MACHINES_AXIS].size()
        return [torch.cat([p] * n, dim=a) for p, a in zip(parts, axes)]
    return "gather", fault


def _altered(par):
    """An answer altered where it is produced: row 0's evaluation."""
    commit_open = par.commit_open

    def fault(bases, rows, alpha):
        com, ev, prf = commit_open(bases, rows, alpha)
        ev = ev.clone()
        ev[0, 0, 0] += 1
        return com, ev, prf
    return "commit_open", fault


FAULTS = {"stale": _stale, "half": _half, "no_exchange": _no_exchange,
          "altered": _altered}


def plant(fault: str, setattr_=setattr) -> None:
    par = _par()
    name, fn = FAULTS[fault](par)
    setattr_(par, name, fn)


#: a fault of the process rather than of the timed path: rank 1 holds a
#: module named ``jax``
JAX_ON_RANK1 = "jax_on_rank1"


def rank_main(root, cell, seed, rank, world, ports, fault, queue):
    """A spawned rank of a CPU run, with ``fault`` (or None) planted;
    rank 0 puts in ``queue`` whether the run was correct and what
    ``run.emit`` makes of its line: the exit code and standard output."""
    torch.set_num_threads(1)
    if fault == JAX_ON_RANK1:
        if rank == 1:
            sys.modules["jax"] = types.ModuleType("jax")
    elif fault:
        plant(fault)
    line = run_cell(root, cell, seed, rank=rank, world=world, ports=ports)
    if rank == 0:
        from benchmark import run
        out = {"correct": line["correct"], "_bad": dict(line["_bad"])}
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            out["rc"] = run.emit(line)
        out["stdout"] = stdout.getvalue()
        queue.put(out)
