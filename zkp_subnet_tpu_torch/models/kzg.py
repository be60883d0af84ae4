"""KZG polynomial commitments: commit / open on the device, verify on the host.

Port of ``zkp_subnet_tpu/models/kzg.py``: commit = MSM(SRS, coefficients),
open = the suffix-sum quotient + MSM over the same bases, verify = one
pairing-product check through the shared native library (``_shared``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops import msm as tmsm
from ..ops import poly as tpoly
from .._shared import native
from .._shared import oracle as o


def commit(bases: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """[f(τ)]G1 from Montgomery coefficients. bases: (N, 3, 12)."""
    return tmsm.msm_auto(bases, tpoly.from_mont_wide(coeffs))


def open_(bases: torch.Tensor, coeffs: torch.Tensor,
          x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f(x) Montgomery, proof [q(τ)]G1); x is (8,) Montgomery. The quotient
    is zero-padded to N scalars (q[N−1] = 0), as in the JAX package."""
    y, scalars = tpoly.poly_open_scalars(coeffs, x)
    return y, tmsm.msm_auto(bases, scalars)


def verify(commitment, x: int, y: int, proof, g2_gen, g2_tau,
           shift_g1=None) -> bool:
    """Host pairing check e(C − y·B, G2) == e(W, [τ − x]G2), B = ``shift_g1``
    or the G1 generator (``zkp_subnet_tpu/models/kzg.py:45-59``)."""
    base = shift_g1 if shift_g1 is not None else o.G1.from_affine(o.G1_GEN)
    c_minus = o.G1.add(commitment, o.G1.neg(o.G1.mul(base, y)))
    tau_minus_x = o.G2.add(g2_tau, o.G2.neg(o.G2.mul(g2_gen, x)))
    return native.pairing_check([
        (c_minus, o.G2.neg(g2_gen)),
        (proof, tau_minus_x),
    ])
