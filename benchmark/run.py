"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration, traffic and metrics. A cell of several ranks starts one
process a card (this one is rank 0) with rendezvous on free local ports.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each compared number
beside its limit, which are also the last lines of standard error.

Without a CUDA device, or with fewer than the cell asks for, it exits 2 and
prints no result. It exits 3 and prints no result if ``jax``, ``jaxlib``,
``flax`` or the JAX package are loaded once the window has closed, in this
process or in any rank's (each rank reports what it holds after its window,
and exits 3 itself if it holds one at its end), and 1 if a rank's process
fails.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.guard import forbidden_loaded  # noqa: E402

NO_DEVICE = 2
FORBIDDEN_LOADED = 3
RANK_FAILED = 1


def parse(argv=None):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a cell of several, started by rank 0
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--ports", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(args, world: int, ports) -> list:
    """Ranks 1 .. world-1, their output on this process's standard
    error."""
    base = [sys.executable, os.path.abspath(__file__),
            "--workload", args.workload, "--seed", str(args.seed),
            "--seconds", str(args.seconds), "--trace", str(args.trace),
            "--world", str(world), "--ports", ",".join(map(str, ports))]
    return [subprocess.Popen(base + ["--rank", str(r)], cwd=ROOT,
                             stdout=sys.stderr.fileno())
            for r in range(1, world)]


def watch(children) -> None:
    """End the run if a rank fails: the others would wait on it."""
    while True:
        for child in children:
            code = child.poll()
            if code not in (None, 0):
                print(f"rank process {child.args[-1]} exited with {code}",
                      file=sys.stderr, flush=True)
                stop(children)
                os._exit(1)
        if all(child.poll() is not None for child in children):
            return
        time.sleep(0.5)


def stop(children, grace: float = 0.0) -> list:
    """Wait ``grace`` seconds for the ranks to end, then end them; their
    exit codes."""
    deadline = time.monotonic() + grace
    for child in children:
        try:
            child.wait(timeout=max(deadline - time.monotonic(), 0.01))
        except subprocess.TimeoutExpired:
            child.terminate()
    for child in children:
        try:
            child.wait(timeout=30)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()
    return [child.returncode for child in children]


def watch_parent() -> None:
    """A rank ends when rank 0 has gone."""
    parent = os.getppid()
    while True:
        if os.getppid() != parent:
            os._exit(1)
        time.sleep(1.0)


def emit(line: dict, codes=()) -> int:
    """Print rank 0's result, or refuse: a rank that held a forbidden
    module after its window (``line["_forbidden"]``, rank 0's own read
    again here) or a rank's process that did not exit 0 (``codes``)."""
    from benchmark import judge
    found = dict(line.pop("_forbidden"))
    mine = forbidden_loaded()
    if mine:
        found[0] = sorted(set(found.get(0, [])) | set(mine))
    for r, names in sorted(found.items()):
        print(f"benchmark: loaded in rank {r}'s process after the window: "
              f"{names}", file=sys.stderr)
    if found:
        return FORBIDDEN_LOADED
    if any(codes):
        print(f"benchmark: rank processes exited with {list(codes)}",
              file=sys.stderr)
        return RANK_FAILED
    for text in judge.lines(line.pop("_bad"), line.pop("_seen")):
        print(text, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from benchmark import result
    from benchmark.rank import Rank
    from benchmark.spec import Spec

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s), "
              f"found {have}", file=sys.stderr)
        return NO_DEVICE
    if args.rank:
        threading.Thread(target=watch_parent, daemon=True).start()
        rank = Rank(spec, args.workload, args.seed, args.seconds,
                    bool(args.trace), args.rank, args.world,
                    [int(p) for p in args.ports.split(",")], "cuda")
        try:
            result.run_rank(rank)
        finally:
            rank.close()
        bad = forbidden_loaded()
        if bad:
            print(f"benchmark: loaded in rank {args.rank}'s process: {bad}",
                  file=sys.stderr)
            return FORBIDDEN_LOADED
        return 0

    from zkp_subnet_tpu_torch.ops import kernels
    kernels.build()                      # once, before any rank loads it
    children, ports = [], None
    if chips > 1:
        ports = [free_port(), free_port()]
        children = spawn_ranks(args, chips, ports)
        threading.Thread(target=watch, args=(children,), daemon=True).start()
    rank = Rank(spec, args.workload, args.seed, args.seconds,
                bool(args.trace), 0, chips, ports, "cuda")
    try:
        line = result.run_rank(rank, T_START)
    finally:
        rank.close()
        codes = stop(children, grace=60)
    return emit(line, codes)


if __name__ == "__main__":
    sys.exit(main())
