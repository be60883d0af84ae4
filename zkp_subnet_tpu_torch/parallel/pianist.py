"""Multi-device Pianist proving: the worker axis sharded over ranks.

Port of ``zkp_subnet_tpu/parallel/pianist.py`` onto ``torch.distributed``.
Where the JAX package lowers the whole distributed prove onto a
``jax.sharding.Mesh`` as one jitted SPMD program, here every rank is one
process with one device, and every rank runs the same Python program:

- ``machines`` axis: Pianist row parallelism (the reference's miner
  fan-out). A rank holds the SRS slices and coefficient rows of its
  workers; the commitments, evals and openings it produces are (3, 12) and
  (8,) a worker, so the one all-gather that replaces the reference's HTTP
  responses moves M tiny payloads.
- ``batch`` axis: independent challenges proved concurrently, pure data
  parallelism.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` of shape
(batch, machines) over the whole world, one device a rank: on the card
``cuda:<local rank>`` with NCCL, on the CPU (only when the caller asks for
it) gloo. The collectives are NCCL's or gloo's, outside the kernels; the
local work runs the worker's kernels (K2 MSMs, K3 openings, K5 NTT
stages) as a single process does.

While torch.profiler records, each layer of a round is a named range of
the trace (``utils/trace.py``): ``zkp.fft``, then ``zkp.prove`` holding
``zkp.commit_open`` (with ``zkp.open`` and the MSMs' ``zkp.msm``, at
2^16 one ``zkp.msm_pass`` a Pippenger pass), ``zkp.gather`` and
``zkp.aggregate``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..models import pianist as pn
from ..models.srs import Srs, entry_device, from_numpy_points
from ..ops import msm as tmsm
from ..ops import ntt as tntt
from ..ops import poly as tpoly
from ..ops.field import FQ, FR
from ..utils.trace import span

BATCH_AXIS = "batch"
MACHINES_AXIS = "machines"

# torch 2.13 renames all_gather_into_tensor to all_gather_single and
# deprecates the old name; earlier releases (the card's 2.11) have the old
# name only
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


# ---------------------------------------------------------------------------
# World and mesh
# ---------------------------------------------------------------------------


def rank_device(device_type: str, rank: Optional[int] = None) -> torch.device:
    """This rank's device. On the card: ``cuda:<local rank>``, the local rank
    being ``LOCAL_RANK`` where torchrun sets it, else the rank modulo the
    host's cards (one process a card). ``rank`` defaults to the world's."""
    if device_type != "cuda":
        return torch.device(device_type)
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        if rank is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
        local = rank % torch.cuda.device_count()
    return torch.device("cuda", int(local))


def init_world(device: torch.device, init_method: Optional[str] = None,
               world_size: int = 1, rank: int = 0) -> None:
    """Start the default process group: NCCL for a CUDA device (bound to it
    before the group starts), gloo for the CPU. Without ``init_method`` the
    world is this process alone, its rendezvous an in-process store."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    if init_method is None:
        kwargs["store"] = dist.HashStore()
    else:
        kwargs["init_method"] = init_method
    dist.init_process_group(backend, world_size=world_size, rank=rank,
                            **kwargs)


def make_mesh(n_machines: Optional[int] = None, n_batch: int = 1,
              device=None) -> DeviceMesh:
    """A (batch, machines) mesh over the initialized world, one device a rank.

    ``device=None`` means the card (and raises without one); ``"cpu"``
    builds a gloo mesh. Where no world is initialized and the mesh is one
    rank, this process becomes a one-rank world, so a single process runs
    the same code."""
    kind = entry_device(device).type
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_machines is None:
        n_machines = world // n_batch
    need = n_batch * n_machines
    if world < need:
        raise ValueError(f"need {need} devices, have {world}")
    if world > need:
        raise ValueError(f"a mesh of {need} ranks in a world of {world}: "
                         "every rank must be on the mesh")
    if not dist.is_initialized():
        init_world(rank_device(kind, 0))
    return init_device_mesh(kind, (n_batch, n_machines),
                            mesh_dim_names=(BATCH_AXIS, MACHINES_AXIS))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device of this rank on ``mesh``."""
    return rank_device(mesh.device_type)


def on_device(device: torch.device):
    """The CUDA device as the current one for the calls inside (kernels
    launch on the current device's stream; an executor thread starts on
    device 0)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _machines(mesh: DeviceMesh):
    """(shards on the machines axis, this rank's coordinate on it)."""
    return (mesh[MACHINES_AXIS].size(),
            mesh.get_local_rank(MACHINES_AXIS))


def shard_srs(srs: Srs, mesh: DeviceMesh) -> Srs:
    """The SRS with only this rank's worker slices: rows [r·Ml, (r+1)·Ml) of
    ``worker_bases`` (one contiguous (Ml, T, 3, 12) tensor) and of
    ``lagrange_y``, r the rank's coordinate on the machines axis, all on the
    rank's device; its ``lagrange_table()`` is the window table of all M
    keys (the aggregation's, built here once). ``scale``/``machines_scale``
    stay the whole SRS's, so ``machines`` is still M. A lazy SRS (a sidecar
    memmap) is read for those rows only, one worker at a time."""
    dev = mesh_device(mesh)
    n, r = _machines(mesh)
    if srs.machines % n:
        raise ValueError(f"{srs.machines} workers do not split over "
                         f"{n} machines")
    ml = srs.machines // n
    lo = r * ml
    bases = srs.worker_bases
    if isinstance(bases, torch.Tensor):
        local = bases[lo:lo + ml].to(dev).contiguous()
    else:
        local = torch.empty((ml, srs.row_size, 3, FQ.L), dtype=torch.int32,
                            device=dev)
        for j in range(ml):
            local[j] = from_numpy_points(
                np.ascontiguousarray(bases[lo + j]), dev)
    keys = srs.lagrange_y.to(dev).contiguous()
    shard = dataclasses.replace(
        srs, g1_x=srs.g1_x.to(dev), worker_bases=local,
        lagrange_y=keys[lo:lo + ml].contiguous())
    # the aggregation runs replicated on every rank, over all M keys: their
    # window table, built here once (not gathered and built a prove)
    with on_device(dev):
        shard.keep_lagrange_table(keys)
    return shard


# ---------------------------------------------------------------------------
# The distributed prove
# ---------------------------------------------------------------------------


class DistributedProof(NamedTuple):
    """This rank's per-worker pieces + the aggregated bivariate proof of each
    of its challenges (the same on every rank of its batch row)."""
    commitments: torch.Tensor    # (Bl, Ml, 3, 12) — this rank's workers
    evals: torch.Tensor          # (Bl, Ml, 8)
    proofs: torch.Tensor         # (Bl, Ml, 3, 12)
    commitment: torch.Tensor     # C   (Bl, 3, 12)
    proof_x: torch.Tensor        # W   (Bl, 3, 12)
    commitment_y: torch.Tensor   # C_y (Bl, 3, 12)
    proof_y: torch.Tensor        # W_y (Bl, 3, 12)
    value: torch.Tensor          # f(α, β) (Bl, 8)


def commit_open(bases: torch.Tensor, rows: torch.Tensor,
                alpha: torch.Tensor):
    """The local step: bases (Ml, T, 3, 12), rows (Bl, Ml, T, 8) Montgomery,
    alpha (8,) → commitments (Bl, Ml, 3, 12), evals (Bl, Ml, 8), proofs
    (Bl, Ml, 3, 12). Worker i's Bl commitments and Bl openings are 2·Bl MSMs
    over its bases, and all Ml workers' MSMs go through one
    ``msm_auto_groups``: at 2^16 a few Pippenger passes, each one chain of
    K2 launches over as many workers as its byte budget holds, with the
    limbs of one batched commit and opening a worker (``kzg.commit_open``).
    Every row opens at alpha, so alpha is inverted once and all Bl·Ml rows
    open in one call (one launch of each opening kernel on the card, the
    tables of alpha and 1/alpha built once)."""
    with span("commit_open"):
        bl, ml, t = rows.shape[:3]
        with span("open"):
            alpha_inv = FR.inv(alpha)
            evals, quotients = tpoly.poly_open_scalars(
                rows.reshape(bl * ml, t, FR.L), alpha, alpha_inv)
        scalars = torch.empty((ml, 2 * bl, t, FR.L), dtype=rows.dtype,
                              device=rows.device)
        scalars[:, :bl] = tpoly.from_mont_wide(rows).transpose(0, 1)
        scalars[:, bl:] = quotients.view(bl, ml, t, FR.L).transpose(0, 1)
        out = tmsm.msm_auto_groups(bases, scalars)       # (Ml, 2Bl, 3, 12)
        return (out[:, :bl].transpose(0, 1).contiguous(),
                evals.view(bl, ml, FR.L),
                out[:, bl:].transpose(0, 1).contiguous())


def gather(mesh: DeviceMesh, parts: Sequence[torch.Tensor],
           axes: Sequence[int]) -> List[torch.Tensor]:
    """Every shard's ``parts`` over the machines axis in ONE all-gather,
    each concatenated along its worker axis (``axes``) in shard order: the
    tiled ``all_gather`` of ``_prove_block``. The collective stacks along a
    new first axis, which is moved to the worker axis here."""
    with span("gather"):
        n, _ = _machines(mesh)
        flat = torch.cat([p.reshape(-1) for p in parts])
        out = torch.empty(n * flat.numel(), dtype=flat.dtype,
                          device=flat.device)
        _all_gather(out, flat, group=mesh.get_group(MACHINES_AXIS))
        out = out.view(n, flat.numel())
        res, off = [], 0
        for p, axis in zip(parts, axes):
            piece = out[:, off:off + p.numel()].reshape((n,) + tuple(p.shape))
            res.append(torch.cat(list(piece), dim=axis))
            off += p.numel()
        return res


def prove_gathered(srs: Srs, rows: torch.Tensor, alpha: torch.Tensor,
                   beta: torch.Tensor, mesh: DeviceMesh):
    """``prove``, and the gathered per-worker pieces (commitments (Bl, M, 3,
    12), evals (Bl, M, 8), proofs (Bl, M, 3, 12)) that the aggregation
    read."""
    dev = mesh_device(mesh)
    for name, t in (("rows", rows), ("alpha", alpha), ("beta", beta)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}; this rank's device "
                             f"is {dev}")
    if rows.shape[1] != srs.worker_bases.shape[0]:
        raise ValueError(f"{rows.shape[1]} rows a challenge for "
                         f"{srs.worker_bases.shape[0]} worker slices")
    with on_device(dev), span("prove"):
        com, ev, prf = commit_open(srs.worker_bases, rows.contiguous(),
                                   alpha)
        coms, evals, prfs = gather(mesh, (com, ev, prf), (1, 1, 1))
        with span("aggregate"):
            dom, m_inv = pn.aggregation_constants(srs.machines, dev)
            C, W, C_y, W_y, value = pn.aggregate_core(
                srs.lagrange_table(), coms, prfs, evals, beta.contiguous(),
                dom, m_inv)
    return (DistributedProof(com, ev, prf, C, W, C_y, W_y, value),
            (coms, evals, prfs))


def prove(srs: Srs, rows: torch.Tensor, alpha: torch.Tensor,
          beta: torch.Tensor, mesh: DeviceMesh) -> DistributedProof:
    """The distributed Pianist prove, on every rank of ``mesh`` at once.

    srs: ``shard_srs``'s; rows: this rank's (Bl, Ml, T, 8) Montgomery
    coefficients; alpha (8,) the shared opening point; beta (Bl, 8) each
    challenge's Y point. Local commit + open, one all-gather of
    commitments, proofs and evals over the machines axis, then the
    aggregation of all Bl challenges at once, replicated on every rank
    (``_prove_block``, ``zkp_subnet_tpu/parallel/pianist.py:80-106``, which
    gathers the Lagrange keys too: here every rank holds their table from
    ``shard_srs``)."""
    return prove_gathered(srs, rows, alpha, beta, mesh)[0]


# ---------------------------------------------------------------------------
# Distributed NTT over the bivariate rows
# ---------------------------------------------------------------------------


def _all_to_all(mesh: DeviceMesh, send: torch.Tensor) -> torch.Tensor:
    """Block s of ``send`` (its first axis) to shard s; block s of the result
    from shard s."""
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.get_group(MACHINES_AXIS))
    return recv


def fft(rows: torch.Tensor, mesh: DeviceMesh, left: bool = True,
        inverse: bool = False) -> torch.Tensor:
    """Distributed ``fft(poly, left, inverse)`` (reference:
    neurons/validator.py:58-65) over this rank's (Bl, Ml, T, 8) rows.

    left=True transforms along X, within each row: no communication.
    left=False transforms along Y, across the M workers (``_fft_cols_block``,
    ``zkp_subnet_tpu/parallel/pianist.py:150-168``): an all-to-all gives
    every shard T/n whole columns, the local NTT runs over their M values,
    and an all-to-all brings the rows back. ``all_to_all_single`` splits
    its first axis only, so the split axis is moved first and made
    contiguous, both ways. Every transform is ``ntt_batch`` (K5)."""
    with span("fft"):
        if left:
            return tntt.ntt_batch(rows, inverse=inverse)
        n, _ = _machines(mesh)
        if n == 1:
            out = tntt.ntt_batch(rows.transpose(1, 2), inverse=inverse)
            return out.transpose(1, 2).contiguous()
        bl, ml, t, l = rows.shape
        if t % n:
            raise ValueError(f"rows of {t} do not split over {n} machines")
        c = t // n
        # (n, Bl, Ml, T/n, L): column block s to shard s
        recv = _all_to_all(mesh, rows.reshape(bl, ml, n, c, l)
                           .permute(2, 0, 1, 3, 4).contiguous())
        # from shard s its Ml workers of my columns → (Bl, T/n, M, L)
        cols = recv.permute(1, 3, 0, 2, 4).reshape(bl, c, n * ml, l)
        out = tntt.ntt_batch(cols, inverse=inverse)
        # workers s·Ml.. back to shard s: (n, Bl, Ml, T/n, L)
        back = _all_to_all(mesh, out.reshape(bl, c, n, ml, l)
                           .permute(2, 0, 3, 1, 4).contiguous())
        return back.permute(1, 2, 0, 3, 4).reshape(bl, ml, t, l)
