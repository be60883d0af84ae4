"""Pianist worker: one resident SRS slice, commit + open per ``Prove``.

Port of ``zkp_subnet_tpu/runtime/worker.py`` (the reference miner's prove
path, reference: neurons/miner.py:38-135). The same ping, commit-only and
response semantics; PyTorch runs eagerly, so there is no program cache and
``warmup`` only builds the kernels and touches every code path once. The
blacklist/priority surface survives as hooks (reference:
neurons/miner.py:63-104) keyed on a static membership set, as in the JAX
package.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional, Set, Tuple

import torch

from ..models import kzg
from ..models.srs import Srs
from ..ops import curve as cv
from ..ops.field import FR
from ..utils import encoding as enc
from .config import WorkerConfig
from .protocol import Prove

log = logging.getLogger("zkp_subnet_tpu_torch.worker")


def prove_row(bases: torch.Tensor, row: torch.Tensor, x: torch.Tensor):
    """(bases, Montgomery row, Montgomery x) → (commitment, f(x), proof):
    the row's scalars and the quotient's first, then both MSMs as one
    (``zkp_subnet_tpu/runtime/worker.py:35-42`` jits both into one
    program)."""
    return kzg.commit_open(bases, row, x)


class Worker:
    """One Pianist worker: holds SRS slices, serves commit/open/verify.

    ``members`` plays the metagraph-registration role for the blacklist hook
    (reference: neurons/miner.py:63-82): requests from unknown callers are
    rejected unless ``allow_non_registered``.
    """

    def __init__(self, srs: Srs, config: Optional[WorkerConfig] = None,
                 members: Optional[Set[str]] = None):
        self.srs = srs
        self.config = config or WorkerConfig()
        self.members = members if members is not None else set()
        self.compressed = not self.config.prover.uncompressed

    @property
    def device(self) -> torch.device:
        """The SRS's device: ``Srs.load``/``generate`` put it on the card
        unless the caller named another."""
        return self.srs.device

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> float:
        """Run one commit+open on a zero row (builds the CUDA kernels on
        first use). Returns the wall time in seconds."""
        t0 = time.perf_counter()
        row = FR.zeros((self.srs.row_size,), self.device)
        prove_row(self.srs.device_worker_bases(0), row,
                  FR.zeros((), self.device))
        self._sync()
        dt = time.perf_counter() - t0
        log.info("warmup ran the prove path in %.1fs", dt)
        return dt

    def _row(self, poly_b64) -> torch.Tensor:
        limbs = enc.b64_to_limbs(poly_b64)              # (N, 16) canonical
        return FR.to_mont(FR.from_limbs16(limbs, self.device))

    def _g1_b64(self, p: torch.Tensor) -> str:
        return enc.g1_to_b64(cv.g1_decode(p)[0], self.compressed)

    # -- RPC-parity compute surface (reference: neurons/miner.py:38-54) -----

    def worker_commit(self, i: int, poly_b64) -> str:
        """b64 row → b64 commitment."""
        return self._g1_b64(kzg.commit(self.srs.device_worker_bases(i),
                                       self._row(poly_b64)))

    def worker_open(self, i: int, poly_b64, x_b64: str) -> Tuple[str, str]:
        """b64 row + point → (b64 eval, b64 proof)."""
        x = FR.encode([enc.fr_from_b64(x_b64)], self.device)[0]
        y, prf = kzg.open_(self.srs.device_worker_bases(i),
                           self._row(poly_b64), x)
        return enc.fr_to_b64(FR.decode(y)[0]), self._g1_b64(prf)

    def worker_verify(self, i: int, proof_b64: str, alpha_b64: str,
                      eval_b64: str, commitment_b64: str) -> bool:
        """Pairing check with the per-worker key (reference:
        neurons/validator.py:77-86). Malformed inputs → False."""
        try:
            proof = enc.g1_from_b64(proof_b64)
            commitment = enc.g1_from_b64(commitment_b64)
            alpha = enc.fr_from_b64(alpha_b64)
            eval_ = enc.fr_from_b64(eval_b64)
        except Exception:
            return False
        v_i = cv.g1_decode(self.srs.lagrange_y[i])[0]
        return kzg.verify(commitment, alpha, eval_, proof,
                          self.srs.g2_gen, self.srs.g2_tau_x, shift_g1=v_i)

    # -- request handling (reference: neurons/miner.py:106-135) -------------

    def forward(self, synapse: Prove) -> Prove:
        """Commit + open the row, timed.

        A request without ``alpha`` is commit-only: the same path runs with
        x = 0 and the opening outputs are dropped. An EMPTY ``poly`` is a
        ping, answered at once with no device work.
        """
        if not synapse.poly:
            out = synapse.response(eval_=None, commitment=None, proof=None)
            out.process_time = 0.0
            return out
        try:
            t0 = time.perf_counter()
            row = self._row(synapse.poly)
            commit_only = synapse.alpha is None
            x = (FR.zeros((), self.device) if commit_only
                 else FR.encode([enc.fr_from_b64(synapse.alpha)],
                                self.device)[0])
            com, y, prf = prove_row(
                self.srs.device_worker_bases(synapse.index), row, x)
            out = synapse.response(
                eval_=None if commit_only else enc.fr_to_b64(FR.decode(y)[0]),
                commitment=self._g1_b64(com),
                proof=None if commit_only else self._g1_b64(prf))
            out.process_time = time.perf_counter() - t0
            return out
        except Exception as exc:
            # parity: on error return the request unchanged, but LOG it —
            # the reference logs before returning (neurons/miner.py:133-135)
            log.error("forward failed for index %s: %s", synapse.index, exc)
            return synapse

    def blacklist(self, caller: str,
                  validator_permits: Optional[Set[str]] = None
                  ) -> Tuple[bool, str]:
        """(should_reject, reason) — reference: neurons/miner.py:63-82.

        With ``force_validator_permit`` (the default, reference
        utils/config.py:191-196) callers must also hold a validator permit;
        pass the permit set from membership state. ``None`` skips the check
        (static deployments where every member is the coordinator).
        """
        if caller not in self.members:
            if self.config.allow_non_registered:
                return False, "allow_non_registered"
            return True, f"unrecognized caller {caller!r}"
        if (self.config.force_validator_permit
                and validator_permits is not None
                and caller not in validator_permits):
            return True, f"caller {caller!r} lacks validator permit"
        return False, "ok"

    def priority(self, caller: str,
                 stake: Callable[[str], float] = lambda _: 0.0) -> float:
        """Queue priority = caller stake (reference: neurons/miner.py:84-104)."""
        return float(stake(caller))
