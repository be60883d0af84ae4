"""Multi-process launch: one process a device, the same program on each.

Port of ``zkp_subnet_tpu/parallel/launch.py`` onto ``torch.distributed``.
The reference deploys miners/validators as pm2 processes per host with a
Makefile (reference: Makefile:63-144) and a docker localnet
(docker-compose.yml:3-50, scripts/localnet.sh). Here every process runs
THE SAME program, the mesh assigns each its Pianist workers, and process 0
narrates:

    # one process a card, on every host:
    torchrun --nproc-per-node 4 -m zkp_subnet_tpu_torch.parallel.launch \\
        --rounds 100 --scale 20 --machines-scale 8
    # or with the three flags, anywhere:
    python -m zkp_subnet_tpu_torch.parallel.launch --rounds 100 \\
        --coordinator-address host0:8476 --num-processes N --process-id i

Without the three flags, torchrun's ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` are read (where the JAX package
auto-detects a Cloud TPU slice). The device is the card (NCCL, rank i on
``cuda:<local rank>``) unless ``--device cpu`` asks for the CPU (gloo);
without a card and without it the command exits 2 before it loads
anything.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Optional

import torch
import torch.distributed as dist

from ..models.srs import entry_device
from . import pianist as par

log = logging.getLogger("zkp_subnet_tpu_torch.launch")

#: the exit code of a launch refused for want of a CUDA device
NO_DEVICE = 2

_TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None) -> int:
    """Bring up the process group; a no-op for a single process.

    Returns this process's rank. Safe to call when already initialized.
    ``device``: None for the card (NCCL), ``"cpu"`` for gloo."""
    if dist.is_initialized():
        return dist.get_rank()
    if (coordinator_address is None and num_processes is None
            and process_id is None and all(k in os.environ
                                           for k in _TORCHRUN)):
        coordinator_address = "{}:{}".format(os.environ["MASTER_ADDR"],
                                             os.environ["MASTER_PORT"])
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    if num_processes in (None, 1) and coordinator_address is None:
        return 0
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a world of several processes needs "
                         "--coordinator-address, --num-processes and "
                         "--process-id (or torchrun's environment)")
    kind = entry_device(device).type
    par.init_world(par.rank_device(kind, process_id),
                   init_method=f"tcp://{coordinator_address}",
                   world_size=num_processes, rank=process_id)
    return process_id


def _rounds(args) -> int:
    from ..models import pianist as pn
    from ..models.srs import Srs, default_paths

    pid = initialize_distributed(args.coordinator_address,
                                 args.num_processes, args.process_id,
                                 args.device)
    is_lead = pid == 0
    n = dist.get_world_size() if dist.is_initialized() else 1
    kind = entry_device(args.device).type
    if is_lead:
        log.info("slice up: %d processes, %d global devices (%s)", n, n,
                 kind)

    machines = 1 << args.machines_scale
    n_batch = max(1, n // machines)
    mesh = par.make_mesh(n_machines=min(machines, n), n_batch=n_batch,
                         device=kind)
    dev = par.mesh_device(mesh)
    if is_lead:
        log.info("mesh %s over %s, backend %s",
                 dict(zip(mesh.mesh_dim_names, mesh.shape)), dev,
                 dist.get_backend())

    setup_p, pre_p = default_paths(args.srs_dir, args.scale,
                                   args.machines_scale)

    def load_or_generate(save: bool) -> Srs:
        try:
            srs = Srs.load(setup_p, pre_p, lazy=True, device=dev)
            if is_lead:
                log.info("loaded SRS from %s", setup_p)
            return srs
        except FileNotFoundError:
            pass
        if is_lead:
            log.info("generating SRS scale=%d machines_scale=%d",
                     args.scale, args.machines_scale)
        srs = Srs.generate(args.scale, args.machines_scale, seed=args.seed,
                           device=dev)
        if save:
            os.makedirs(args.srs_dir, exist_ok=True)
            srs.save(setup_p, pre_p)
        return srs

    # the lead writes the files first; the others then load them, or
    # generate the same SRS from the seed where they cannot see them
    srs = load_or_generate(save=True) if is_lead else None
    dist.barrier()
    if not is_lead:
        srs = load_or_generate(save=False)
    srs = par.shard_srs(srs, mesh)

    b = mesh.get_local_rank(par.BATCH_AXIS)
    ml = srs.worker_bases.shape[0]
    lo = mesh.get_local_rank(par.MACHINES_AXIS) * ml
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for step in range(args.rounds):
        rows = pn._uniform_fr(gen, (n_batch, srs.machines, srs.row_size))
        alpha = pn.random_point(gen)
        beta = pn._uniform_fr(gen, (n_batch,))
        local = rows[b:b + 1, lo:lo + ml].contiguous()
        del rows
        coeff = par.fft(local, mesh, left=True, inverse=True)
        out = par.prove(srs, coeff, alpha, beta[b:b + 1], mesh)
        out.value.cpu()                       # waits for the device
        if is_lead:
            log.info("round %d: %d sub-proofs aggregated", step,
                     n_batch * srs.machines)
    return 0


def launch(args) -> int:
    """SPMD entry: the same program in every process; process 0 narrates.
    A process group this call starts, it also ends."""
    owned = not dist.is_initialized()
    try:
        return _rounds(args)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="zkp_subnet_tpu_torch.parallel.launch")
    p.add_argument("--coordinator-address", default=None,
                   help="host:port of process 0 (else torchrun's "
                   "MASTER_ADDR:MASTER_PORT)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--scale", type=int, default=18)
    p.add_argument("--machines-scale", dest="machines_scale", type=int,
                   default=8)
    p.add_argument("--srs-dir", default="./artifacts")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device type of every process (default: the "
                   "CUDA device, NCCL; 'cpu' runs gloo and the plain "
                   "PyTorch versions)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    if args.device is None and not torch.cuda.is_available():
        print("zkp_subnet_tpu_torch.parallel.launch: no CUDA device; pass "
              "--device cpu to run on the CPU", file=sys.stderr)
        return NO_DEVICE
    return launch(args)


if __name__ == "__main__":
    sys.exit(main())
