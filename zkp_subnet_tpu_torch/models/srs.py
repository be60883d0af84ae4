"""The KZG structured reference string, read side.

Loads the files ``zkp_subnet_tpu.models.srs.Srs.save`` and
``Srs.generate_to_disk`` write (two ``.npz`` files, and for large scales a
``<precompute>.bases.npy`` sidecar) with numpy, and carries the JAX
package's point arrays ((…, 3, 24) uint32 16-bit limbs, Montgomery) to the
port's (…, 3, 12) int32 tensors on a device: ``from_numpy_points`` and its
inverse ``to_numpy_points``. Generation waits for a later port.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..ops.field import FQ
from .._shared import encoding as enc

FORMAT_VERSION = 1


def from_numpy_points(arr, device=None) -> torch.Tensor:
    """(…, 3, 24) uint32 16-bit limbs (JAX format) → (…, 3, 12) int32."""
    return FQ.from_limbs16(arr, device)


def to_numpy_points(t: torch.Tensor) -> np.ndarray:
    """(…, 3, 12) int32 → (…, 3, 24) uint32 16-bit limbs (JAX format)."""
    return FQ.to_limbs16(t)


@dataclasses.dataclass
class Srs:
    """Device-resident SRS (the fields of ``zkp_subnet_tpu.models.srs.Srs``).

    g1_x: (T, 3, 12) — [τ_X^j]G1; worker_bases: (M, T, 3, 12) —
    [R_i(τ_Y)·τ_X^j]G1; lagrange_y: (M, 3, 12) — [R_i(τ_Y)]G1;
    g2_gen / g2_tau_x / g2_tau_y: host oracle G2 points.
    """
    scale: int
    machines_scale: int
    g1_x: torch.Tensor
    worker_bases: torch.Tensor
    lagrange_y: torch.Tensor
    g2_gen: tuple
    g2_tau_x: tuple
    g2_tau_y: tuple

    @property
    def machines(self) -> int:
        return 1 << self.machines_scale

    @property
    def row_size(self) -> int:
        return 1 << (self.scale - self.machines_scale)

    @classmethod
    def load(cls, setup_path: str, precompute_path: str,
             device=None) -> "Srs":
        """Load a JAX-written SRS pair onto ``device``."""
        for path in (setup_path, precompute_path):
            if not os.path.exists(path):
                raise FileNotFoundError(path)
        with np.load(setup_path) as s, np.load(precompute_path) as p:
            if int(s["version"]) != FORMAT_VERSION:
                raise ValueError("unsupported setup format")
            if int(s["scale"]) != int(p["scale"]) or \
                    int(s["machines_scale"]) != int(p["machines_scale"]):
                raise ValueError("setup/precompute mismatch")
            if "worker_bases" in p.files:
                bases = p["worker_bases"]
            else:
                bases = np.load(precompute_path + ".bases.npy",
                                mmap_mode="r")
            return cls(
                scale=int(s["scale"]),
                machines_scale=int(s["machines_scale"]),
                g1_x=from_numpy_points(s["g1_x"], device),
                worker_bases=from_numpy_points(bases, device),
                lagrange_y=from_numpy_points(p["lagrange_y"], device),
                g2_gen=enc.g2_from_bytes(s["g2_gen"].tobytes()),
                g2_tau_x=enc.g2_from_bytes(s["g2_tau_x"].tobytes()),
                g2_tau_y=enc.g2_from_bytes(s["g2_tau_y"].tobytes()),
            )
