"""One rank of one run of a cell: set-up, the measured window, the
observations the judge compares, and (rank 0) the result.

The window drives what ``parallel.launch`` runs a round, through the
port's public functions: ``parallel.pianist.fft`` (the traffic's inverse
NTTs, by default the X axis's alone) and ``parallel.pianist.prove`` on
this rank's block of the round's challenges, closed loop, one round in
flight; a round ends when the aggregated values are on the host. Set-up,
once: ``Srs.generate`` on the device from the seed's trapdoor,
``make_mesh``, ``shard_srs`` (the Lagrange keys' table), the challenge
pool, and one warm round on a pool entry of its own.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import tempfile
import time
import types
from datetime import timedelta
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import judge as judge_mod
from . import reference as ref
from . import trace as trace_mod
from .guard import forbidden_loaded
from .roofline import peaks
from .spec import Spec
from .traffic import Traffic

LOCALHOST = "127.0.0.1"
#: how long a rank waits for another at a rendezvous of the harness
WAIT = timedelta(seconds=900)


def _span(trace: bool, name: str):
    if not trace:
        return contextlib.nullcontext()
    return torch.profiler.record_function(trace_mod.PREFIX + name)


class Rank:
    """What one process of the run holds."""

    def __init__(self, spec: Spec, cell_name: str, seed: int,
                 seconds: float, trace: bool, rank: int, world: int,
                 ports, device_type: str):
        self.spec, self.seed, self.seconds = spec, seed, seconds
        self.trace, self.rank, self.world = trace, rank, world
        self.cell = spec.cell(cell_name)
        self.config = spec.config(self.cell)
        self.traffic = Traffic(spec.traffic(self.cell), self.config, seed)
        if self.traffic.ranks != world:
            raise ValueError(f"traffic {self.cell['traffic']} needs "
                             f"{self.traffic.ranks} ranks, not {world}")
        self.ports = ports
        self.device_type = device_type
        self.store = None

    # -- set-up ---------------------------------------------------------

    def set_up(self) -> None:
        marks = [("start", time.perf_counter())]

        def mark(name):
            marks.append((name, time.perf_counter()))
        from zkp_subnet_tpu_torch.models.srs import Srs
        from zkp_subnet_tpu_torch.ops import kernels
        from zkp_subnet_tpu_torch.parallel import launch as plaunch
        from zkp_subnet_tpu_torch.parallel import pianist as par
        self.par, self.kernels = par, kernels
        if self.world > 1:
            plaunch.initialize_distributed(
                f"{LOCALHOST}:{self.ports[0]}", self.world, self.rank,
                device=self.device_type)
            self.store = dist.TCPStore(LOCALHOST, self.ports[1], self.world,
                                       self.rank == 0, timeout=WAIT)
        tr = self.traffic
        self.mesh = par.make_mesh(n_machines=tr.machine_ranks,
                                  n_batch=tr.batch_ranks,
                                  device=self.device_type)
        self.dev = par.mesh_device(self.mesh)
        mark("world")
        tau_x, tau_y = tr.trapdoor()
        srs = Srs.generate(self.config["scale"],
                           self.config["machines_scale"], tau_x=tau_x,
                           tau_y=tau_y, device=self.dev)
        mark("srs")
        self.srs = par.shard_srs(srs, self.mesh)
        del srs
        mark("shard")
        self.ml = self.srs.worker_bases.shape[0]
        self.lo = self.mesh.get_local_rank(par.MACHINES_AXIS) * self.ml
        b = self.mesh.get_local_rank(par.BATCH_AXIS) * tr.rank_batch
        self.members = list(range(b, b + tr.rank_batch))
        self.pool = torch.stack([self.block(c) for c in range(tr.pool)])
        self.alphas = [tr.point(c, "alpha", self.dev) for c in range(tr.pool)]
        self.betas = [self.beta(c) for c in range(tr.pool)]
        warm = self.block(-1)
        self.sync()
        mark("pool")
        self.round(warm, tr.point(-1, "alpha", self.dev), self.beta(-1),
                   False)
        self.sync()
        mark("warm")
        if self.store is not None:
            self.store.set(f"ready{self.rank}", b"1")
            for r in range(self.world):
                self.store.get(f"ready{r}")
        mark("ready")
        print(f"rank {self.rank} set-up: " + ", ".join(
            f"{name} {t - marks[k][1]:.2f} s"
            for k, (name, t) in enumerate(marks[1:])), file=sys.stderr,
            flush=True)

    def block(self, c: int) -> torch.Tensor:
        """This rank's (Bl, Ml, T, 8) evaluations of pool entry c."""
        return torch.stack([self.traffic.rows(c, self.lo, self.lo + self.ml,
                                              self.dev, g)
                            for g in self.members])

    def beta(self, c: int) -> torch.Tensor:
        """This rank's (Bl, 8) betas of pool entry c."""
        return torch.stack([self.traffic.point(c, "beta", self.dev, g)
                            for g in self.members])

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def launches(self) -> int:
        return sum(self.kernels.LAUNCHES.values())

    # -- the window -----------------------------------------------------

    def round(self, rows, alpha, beta, trace: bool):
        par = self.par
        coeffs = rows
        with _span(trace, "fft"):
            for axis in self.traffic.transforms:
                coeffs = par.fft(coeffs, self.mesh, left=axis == "x",
                                 inverse=True)
        with _span(trace, "prove"):
            out = par.prove(self.srs, coeffs, alpha, beta, self.mesh)
        with _span(trace, "host_copy"):
            value = out.value.cpu()
        return coeffs, out, value

    def window(self) -> None:
        tr = self.traffic
        sampled = set(tr.sampled_rounds())
        self.times: List[tuple] = []
        self.outs, self.values, self.kept = [], [], {}
        profiler = None
        if self.trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=acts)
            profiler.start()
        before = self.launches()
        k = 0
        with _span(self.trace, "window"):
            first = time.perf_counter()
            while True:
                t0 = time.perf_counter()
                with _span(self.trace, "hand_in"):
                    c = tr.challenge_of(k)
                    rows, alpha, beta = (self.pool[c], self.alphas[c],
                                         self.betas[c])
                coeffs, out, value = self.round(rows, alpha, beta,
                                                self.trace)
                t1 = time.perf_counter()
                self.times.append((t0, t1))
                self.outs.append(out)
                self.values.append(value)
                if k in sampled:
                    self.kept[k] = coeffs
                k += 1
                if not self.go_on(k, t1 - first >= self.seconds):
                    break
        self.sync()
        self.launch_count = self.launches() - before
        self.peak = (torch.cuda.max_memory_allocated(self.dev)
                     if self.dev.type == "cuda" else 0)
        self.summary = None
        if profiler is not None:
            profiler.stop()
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                profiler.export_chrome_trace(path)
                events = trace_mod.load(path)
            finally:
                os.remove(path)
            self.summary = trace_mod.summarize(events,
                                               self.spec.layer_rules())

    def go_on(self, k: int, done: bool) -> bool:
        """Rank 0's word on whether round k runs, given to every rank."""
        if self.store is None:
            return not done
        if self.rank == 0:
            self.store.set(f"go{k}", b"0" if done else b"1")
            return not done
        return self.store.get(f"go{k}") == b"1"

    # -- after the window -----------------------------------------------

    def observe(self) -> dict:
        """This rank's outputs for the judge, on the host."""
        tr, srs = self.traffic, self.srs
        bl = len(self.members)
        obs = {"row_lo": np.int64(self.lo),
               "members": np.array(self.members, np.int64),
               "challenge": np.array([tr.challenge_of(k)
                                      for k in range(len(self.outs))],
                                     np.int64),
               "value": torch.stack(self.values).reshape(
                   -1, bl, ref.FR_WORDS).numpy(),
               "agg": torch.stack([torch.stack(
                   [o.commitment, o.proof_x, o.commitment_y, o.proof_y], 1)
                   for o in self.outs]).cpu().numpy()}
        rows = judge_mod.empty_rows(self.ml, bl)
        if self.kept:
            ks = sorted(self.kept)
            limbs = ref.weight_limbs([ref.powers(tr.z(), tr.row)], self.dev)
            rows = {"sampled": np.array(ks, np.int64),
                    "com": torch.stack([self.outs[k].commitments
                                        for k in ks]).cpu().numpy(),
                    "eval": torch.stack([self.outs[k].evals
                                         for k in ks]).cpu().numpy(),
                    "proof": torch.stack([self.outs[k].proofs
                                          for k in ks]).cpu().numpy(),
                    "coeff_dot": torch.stack([
                        ref.dot_sums(self.kept[k].reshape(
                            bl * self.ml, tr.row, ref.FR_WORDS),
                            limbs)[:, 0].reshape(bl, self.ml, -1)
                        for k in ks]).cpu().numpy()}
        obs.update(rows)
        picks = tr.srs_indices()
        mine = (picks["bases"][:, 0] >= self.lo) & (
            picks["bases"][:, 0] < self.lo + self.ml)
        keys = (picks["lagrange_y"][:, 0] >= self.lo) & (
            picks["lagrange_y"][:, 0] < self.lo + self.ml)
        sources = {
            "g1_x": (picks["g1_x"], lambda i: srs.g1_x[i[0]]),
            "bases": (picks["bases"][mine],
                      lambda i: srs.worker_bases[i[0] - self.lo, i[1]]),
            "lagrange_y": (picks["lagrange_y"][keys],
                           lambda i: srs.lagrange_y[i[0] - self.lo])}
        for kind, (idx, get) in sources.items():
            obs[f"srs_{kind}_idx"] = idx
            obs[f"srs_{kind}"] = (
                torch.stack([get(i) for i in idx]).cpu().numpy() if len(idx)
                else np.zeros((0, 3, ref.FQ_WORDS), np.int32))
        meta = {"peak": int(self.peak), "launches": int(self.launch_count),
                "summary": self.summary, "forbidden": forbidden_loaded()}
        obs["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
        return obs

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        for name in ("srs", "outs", "kept", "mesh"):
            self.__dict__.pop(name, None)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def exchange(self, obs: dict) -> Optional[List[dict]]:
        """Every rank's observations at rank 0 (None elsewhere)."""
        if self.store is None:
            return [obs]
        if self.rank != 0:
            buf = io.BytesIO()
            np.savez(buf, **obs)
            self.store.set(f"obs{self.rank}", buf.getvalue())
            return None
        out = [obs]
        for r in range(1, self.world):
            with np.load(io.BytesIO(self.store.get(f"obs{r}")),
                         allow_pickle=False) as f:
                out.append({k: f[k] for k in f.files})
        return out

    def expected(self, obs: List[dict]) -> tuple:
        """The reference of every challenge the rounds proved, by (pool
        entry, challenge), worked out on this rank's device; the rows of
        other ranks are drawn again."""
        tr = self.traffic
        reference = ref.Reference(*tr.trapdoor(), tr.workers, tr.row,
                                  tr.z(), self.dev, tr.transforms)
        out = {}
        for c, g in sorted({(int(c), int(g)) for o in obs
                            for c in o["challenge"] for g in o["members"]}):
            blocks = [self.pool[c][self.members.index(g)]
                      if lo == self.lo and g in self.members else
                      tr.rows(c, lo, lo + self.ml, self.dev, g)
                      for lo in range(0, tr.workers, self.ml)]
            out[c, g] = reference.challenge(
                torch.cat(blocks),
                ref.fr_values(self.alphas[c].cpu().numpy())[0],
                ref.fr_values(tr.point(c, "beta", self.dev, g).cpu()
                              .numpy())[0])
        return out, reference

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


def reader_context(rank: Rank, obs: List[dict], setup_s: float) -> object:
    """What the metric readers read (``metrics/<name>.py``)."""
    metas = [json.loads(bytes(o["meta"]).decode()) for o in obs]
    tr = rank.traffic
    shape = {"rows_local": rank.ml, "row": tr.row, "workers": tr.workers,
             "batch": tr.rank_batch, "machine_ranks": tr.machine_ranks,
             "transforms": tr.transforms}
    card = None
    if rank.dev.type == "cuda":
        card = peaks.card(torch.cuda.get_device_properties(
            rank.dev).multi_processor_count)
    return types.SimpleNamespace(
        times=rank.times, rounds=len(rank.times),
        rows_per_round=tr.rows_per_round,
        setup_s=setup_s, launches=metas[0]["launches"],
        summaries=[m["summary"] for m in metas if m["summary"]],
        shape=shape, card=card, peak=max(m["peak"] for m in metas),
        forbidden={r: m["forbidden"] for r, m in enumerate(metas)
                   if m["forbidden"]})
