"""A dry run of the multi-device path on tiny shapes.

The port's counterpart of ``__graft_entry__.py:dryrun_multichip``: an
n-rank (batch, machines) mesh, the distributed NTT both ways, one
distributed prove, and one SCORED round through ``Coordinator`` and
``MeshTransport``, every reward > 0. In a world of n ranks already started
every rank calls it; otherwise a one-rank run happens in this process (on
the card: one NCCL rank), and n > 1 ranks are n processes of this module,
each on its own device (gloo on the CPU, NCCL on n cards):

    python -c "from zkp_subnet_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(4, device='cpu')"
"""

from __future__ import annotations

import argparse
import asyncio
import os
import socket
import subprocess
import sys

import torch
import torch.distributed as dist

from ..models.srs import entry_device

#: seconds a spawned rank may take before the run is called failed
RANK_TIMEOUT = 600.0


def _factor(n_ranks: int):
    """(n_batch, machines): machines the largest power of two dividing
    n_ranks, as the JAX dry run factors its devices."""
    machines = 1
    while machines * 2 <= n_ranks and n_ranks % (machines * 2) == 0:
        machines *= 2
    return n_ranks // machines, machines


def _run(n_ranks: int, device) -> None:
    """The dry run itself, on every rank of an n_ranks world (or alone)."""
    from ..models import pianist as pn
    from ..models.srs import Srs
    from ..ops.field import FR
    from ..runtime import Coordinator, CoordinatorConfig, MeshTransport
    from . import pianist as par

    n_batch, machines = _factor(n_ranks)
    mesh = par.make_mesh(n_machines=machines, n_batch=n_batch,
                         device=device)
    dev = par.mesh_device(mesh)
    machines_scale = machines.bit_length() - 1
    srs = Srs.generate(machines_scale + 3, machines_scale, seed=2,
                       device=dev)                          # rows of T = 8
    sharded = par.shard_srs(srs, mesh)

    gen = torch.Generator(device=dev).manual_seed(1)
    rows = pn._uniform_fr(gen, (n_batch, srs.machines, srs.row_size))
    alpha = pn.random_point(gen)
    beta = pn._uniform_fr(gen, (n_batch,))
    b = mesh.get_local_rank(par.BATCH_AXIS)
    ml = sharded.worker_bases.shape[0]
    lo = mesh.get_local_rank(par.MACHINES_AXIS) * ml
    local = rows[b:b + 1, lo:lo + ml].contiguous()

    # the distributed NTT both ways (left: along X; right: across machines)
    coeff = par.fft(local, mesh, left=True, inverse=True)
    cols = par.fft(coeff, mesh, left=False, inverse=False)
    if not torch.equal(par.fft(cols, mesh, left=False, inverse=True), coeff):
        raise AssertionError("the Y-axis NTT did not round-trip")

    out, (_, evals, _) = par.prove_gathered(sharded, coeff, alpha,
                                            beta[b:b + 1], mesh)
    agg = pn.AggregatedProof(
        commitment=out.commitment[0], proof_x=out.proof_x[0], evals=evals[0],
        commitment_y=out.commitment_y[0], proof_y=out.proof_y[0],
        value=out.value[0])
    if not pn.verify_aggregated(srs, agg, FR.decode(alpha)[0],
                                FR.decode(beta[b])[0]):
        raise AssertionError("the distributed proof does not verify")

    # one SCORED round over the mesh: the Coordinator's reward/EMA loop
    # driving MeshTransport (a distributed prove, pairing checks, scores)
    hotkeys = [f"chip{i}" for i in range(srs.machines)]
    coord = Coordinator(
        srs, CoordinatorConfig(sample_size=srs.machines, timeout=600.0),
        hotkeys=hotkeys, seed=3)
    _, _, rewards = asyncio.run(coord.forward(MeshTransport(sharded, mesh)))
    if not (rewards > 0).all():
        raise AssertionError(f"mesh round rewards not all positive: {rewards}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(n_ranks: int, kind: str) -> None:
    """n_ranks processes of this module, one a rank, on 127.0.0.1."""
    address = f"127.0.0.1:{_free_port()}"
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env.pop("LOCAL_RANK", None)         # each rank's card is its rank's
    procs = [subprocess.Popen(
        [sys.executable, "-m", __name__, str(n_ranks), "--rank", str(r),
         "--address", address, "--device", kind],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n_ranks)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, out)
              for r, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        r, rc, out = failed[0]
        raise RuntimeError(f"dry run rank {r} of {n_ranks} exited {rc}:\n"
                           f"{out[-3000:]}")


def dryrun_multichip(n_ranks: int, device=None) -> None:
    """Build an n_ranks (batch, machines) mesh and run the distributed path
    once on tiny shapes (scale machines_scale + 3). ``device=None`` means
    the card and raises without one; ``"cpu"`` runs gloo."""
    kind = entry_device(device).type
    if dist.is_initialized() or n_ranks == 1:
        _run(n_ranks, kind)
        return
    if kind == "cuda":
        if torch.cuda.device_count() < n_ranks:
            raise ValueError(f"need {n_ranks} devices, have "
                             f"{torch.cuda.device_count()}")
        from ..ops import kernels
        kernels.build()                 # once, before the ranks load it
    _spawn(n_ranks, kind)


def main(argv=None) -> int:
    """One spawned rank of ``dryrun_multichip``."""
    from .launch import initialize_distributed
    p = argparse.ArgumentParser(prog="zkp_subnet_tpu_torch.parallel.dryrun")
    p.add_argument("ranks", type=int)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--address", required=True)
    p.add_argument("--device", required=True)
    args = p.parse_args(argv)
    torch.set_num_threads(1)            # the ranks share the host's cores
    initialize_distributed(args.address, args.ranks, args.rank, args.device)
    try:
        _run(args.ranks, args.device)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
