"""Pianist-style distributed KZG prover (eprint 2023/1271) on torch tensors.

Port of ``zkp_subnet_tpu/models/pianist.py``. The bivariate witness
f(X, Y) = Σ_i R_i(Y)·f_i(X) is sharded row-per-worker: M = 2^machines_scale
workers, each holding T = 2^(scale − machines_scale) coefficients.

- ``worker_commit(i, row)``  → com_i = [R_i(τ_Y)·f_i(τ_X)]G1
- ``worker_open(i, row, x)`` → (f_i(x), W_i = [R_i(τ_Y)·q_i(τ_X)]G1)
- ``worker_verify(i, ...)``  → pairing check with the key V_i = [R_i(τ_Y)]G1

and the aggregation: per-worker commitments and proofs sum to a commitment
and a proof for f itself,
    C = Σ C_i,  W = Σ W_i,  C_y = Σ y_i·V_i = [y(τ_Y)]G1
with y(Y) = f(α, Y) in Lagrange form. Two pairing checks make the full
bivariate opening at (α, β):
    e(C − C_y, G2) == e(W, [τ_X − α]G2)            (X opening, aggregated)
    e(C_y − f(α,β)·G1, G2) == e(W_y, [τ_Y − β]G2)  (Y opening, Lagrange KZG)

Where the JAX package maps over the worker axis with ``vmap``, the port
hands every worker's bases to one ``msm_auto_many``. Where it runs the
aggregation's Lagrange-Y MSMs as naive ladders (``msm_auto``), the port
runs both through one ``msm_fixed`` over a window table of the keys that
the SRS builds once (``Srs.lagrange_table``). Random draws take an
explicit ``torch.Generator``; they are uniform but not the JAX package's
numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import torch

from ..ops import curve as cv
from ..ops import msm as tmsm
from ..ops import ntt as tntt
from ..ops import poly as tpoly
from ..ops.field import FR
from ..utils import native
from ..utils import oracle as o
from . import kzg
from .srs import Srs, entry_device, from_numpy_points, to_numpy_points


# ---------------------------------------------------------------------------
# Worker-side programs
# ---------------------------------------------------------------------------


def worker_commit(srs: Srs, i: int, row: torch.Tensor) -> torch.Tensor:
    """Commitment of worker i's row (coefficients, Montgomery form)."""
    return kzg.commit(srs.device_worker_bases(i), row)


def worker_open(srs: Srs, i: int, row: torch.Tensor, x: torch.Tensor):
    """(f_i(x), W_i) for worker i; x (8,) Montgomery."""
    return kzg.open_(srs.device_worker_bases(i), row, x)


def worker_verify(srs: Srs, i: int, proof, alpha: int, eval_: int,
                  commitment) -> bool:
    """Pairing check for one worker's proof (host-side; oracle points)."""
    v_i = cv.g1_decode(srs.lagrange_y[i])[0]
    return kzg.verify(commitment, alpha, eval_, proof,
                      srs.g2_gen, srs.g2_tau_x, shift_g1=v_i)


def _worker_bases(srs: Srs, m: int) -> torch.Tensor:
    return torch.stack([srs.device_worker_bases(i) for i in range(m)])


def commit_all(srs: Srs, rows: torch.Tensor) -> torch.Tensor:
    """All workers' commitments: rows (M, T, 8) → (M, 3, 12), the limbs of
    ``worker_commit`` for each."""
    return tmsm.msm_auto_many(_worker_bases(srs, rows.shape[0]),
                              tpoly.from_mont_wide(rows))


def open_all(srs: Srs, rows: torch.Tensor,
             x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """All workers' openings at the shared point x: ((M, 8), (M, 3, 12)),
    the limbs of ``worker_open`` for each. x is inverted once for all the
    rows (one K3 ``fr_inv`` on the card, not one a row), and the rows open
    in one call (one launch of each opening kernel)."""
    ys, quotients = tpoly.poly_open_scalars(rows, x, FR.inv(x))
    return ys, tmsm.msm_auto_many(_worker_bases(srs, rows.shape[0]),
                                  quotients)


# ---------------------------------------------------------------------------
# Aggregation (the Pianist coordinator step)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AggregatedProof:
    """One proof for the whole bivariate f, built from worker sub-proofs."""
    commitment: torch.Tensor      # C = Σ C_i                       (3, 12)
    proof_x: torch.Tensor         # W = Σ W_i                       (3, 12)
    evals: torch.Tensor           # y_i = f_i(α)                    (M, 8)
    commitment_y: torch.Tensor    # C_y = Σ y_i·V_i                 (3, 12)
    proof_y: torch.Tensor         # W_y (Lagrange KZG open of y at β)
    value: torch.Tensor           # f(α, β)                         (8,)

    _POINTS = ("commitment", "proof_x", "commitment_y", "proof_y")
    _SCALARS = ("evals", "value")

    @classmethod
    def from_numpy(cls, fields: Mapping, device=None) -> "AggregatedProof":
        """From the fields of the JAX package's ``AggregatedProof`` as numpy
        (16-bit-limb uint32 arrays). ``device=None`` means the CUDA device
        and raises where there is none, as ``Srs.from_numpy`` does."""
        device = entry_device(device)
        return cls(
            **{k: from_numpy_points(fields[k], device) for k in cls._POINTS},
            **{k: FR.from_limbs16(fields[k], device) for k in cls._SCALARS})

    def to_numpy(self) -> dict:
        """The inverse of ``from_numpy``."""
        return {**{k: to_numpy_points(getattr(self, k))
                   for k in self._POINTS},
                **{k: FR.to_limbs16(getattr(self, k))
                   for k in self._SCALARS}}


def _lagrange_eval_domain(m: int, device=None) -> torch.Tensor:
    """Montgomery-form domain points ω^i for the size-m worker domain."""
    log_m = m.bit_length() - 1
    w = FR.encode([o.fr_root_of_unity(log_m)], device)[0]
    return FR.powers(w, m)                       # (m, 8)


def _rows(t: torch.Tensor, b: int, m: int) -> torch.Tensor:
    """(M, 8) or (B, 1, 8) broadcast to a contiguous (B, M, 8): the
    elementwise Fr kernels take operands of one shape (or one element)."""
    return t.expand(b, m, FR.L).contiguous()


def aggregate_core(lagrange_table: torch.Tensor, commitments: torch.Tensor,
                   proofs: torch.Tensor, evals: torch.Tensor,
                   beta: torch.Tensor, dom: torch.Tensor,
                   m_inv: torch.Tensor):
    """The aggregation math for B challenges at once. lagrange_table: the
    Lagrange-Y keys' window table (``Srs.lagrange_table``, (M, 64, 8, 3,
    12)); commitments, proofs (B, M, 3, 12); evals (B, M, 8), beta (B, 8),
    all Montgomery; dom (M, 8) = domain points ω^i, m_inv (8,) = 1/M.
    Returns (C, W, C_y, W_y, value), each with the leading B.

    On the card: one K3 ``fr_inv`` for the B·M differences (the quotient's
    1/(ω^i − β) is the negation of 1/(β − ω^i), so the difference's sign
    moves to the numerator), and one ``msm_fixed`` call (K1
    ``g1_msm_fixed``, one tree of launches, any M) for the 2·B MSMs C_y =
    Σ y_i·V_i and W_y = Σ q_i·V_i, once value and q are known; C and W by
    one tree of K1 adds over both."""
    b, m = evals.shape[:2]
    dom_b = _rows(dom, b, m)
    C, W = cv.tree_sum(torch.stack([commitments, proofs], 1).reshape(
        2 * b, m, 3, -1), cv.g1_add, cv.g1_infinity((), evals.device)).view(
            b, 2, 3, -1).unbind(1)

    # y(β) via barycentric: (β^m − 1)/m · Σ y_i·ω^i/(β − ω^i)
    inv_diff = FR.inv(FR.sub(_rows(beta[:, None], b, m), dom_b))
    s = cv.tree_sum(FR.mont_mul(FR.mont_mul(evals, dom_b), inv_diff),
                    FR.add, FR.zeros((), evals.device))
    num = FR.sub(FR.pow_static(beta, m), FR.ones((), beta.device))
    value = FR.mont_mul(FR.mont_mul(num, m_inv), s)

    # quotient in Lagrange form: q_i = (y_i − v)/(ω^i − β)
    #                                = (v − y_i)/(β − ω^i)
    q_evals = FR.mont_mul(FR.sub(_rows(value[:, None], b, m), evals),
                          inv_diff)
    # C_y = Σ y_i·V_i and W_y = Σ q_i·V_i: MSMs over the Lagrange-Y basis
    scalars = FR.from_mont(torch.stack([evals, q_evals], 1))
    C_y, W_y = tmsm.msm_fixed(lagrange_table, scalars.reshape(
        2 * b, m, FR.L)).view(b, 2, 3, -1).unbind(1)
    return C, W, C_y, W_y, value


def aggregation_constants(m: int, device=None):
    """(dom, m_inv) Montgomery tensors for ``aggregate_core``."""
    dom = _lagrange_eval_domain(m, device)
    m_inv = FR.encode([pow(m, o.R - 2, o.R)], device)[0]
    return dom, m_inv


def aggregate(srs: Srs, commitments: torch.Tensor, proofs: torch.Tensor,
              evals: torch.Tensor, beta: torch.Tensor) -> AggregatedProof:
    """Fold per-worker sub-proofs into a single bivariate opening at (α, β).

    commitments/proofs: (M, 3, 12); evals: (M, 8) Montgomery; beta (8,).
    """
    dom, m_inv = aggregation_constants(srs.machines, evals.device)
    C, W, C_y, W_y, value = (x[0] for x in aggregate_core(
        srs.lagrange_table(), commitments[None], proofs[None], evals[None],
        beta[None], dom, m_inv))
    return AggregatedProof(commitment=C, proof_x=W, evals=evals,
                           commitment_y=C_y, proof_y=W_y, value=value)


def verify_aggregated(srs: Srs, agg: AggregatedProof, alpha: int,
                      beta: int) -> bool:
    """Both pairing checks for the aggregated bivariate opening (host-side).
    As in the JAX package, ``agg.evals`` enters only through C_y, W_y and
    the value that ``aggregate`` derived from it."""
    g1 = o.G1.from_affine(o.G1_GEN)
    C = cv.g1_decode(agg.commitment)[0]
    W = cv.g1_decode(agg.proof_x)[0]
    C_y = cv.g1_decode(agg.commitment_y)[0]
    W_y = cv.g1_decode(agg.proof_y)[0]
    value = FR.decode(agg.value)[0]

    # X opening: e(C − C_y, −G2)·e(W, [τ_X − α]G2) == 1
    tau_minus_a = o.G2.add(srs.g2_tau_x,
                           o.G2.neg(o.G2.mul(srs.g2_gen, alpha)))
    ok_x = native.pairing_check([
        (o.G1.add(C, o.G1.neg(C_y)), o.G2.neg(srs.g2_gen)),
        (W, tau_minus_a),
    ])
    # Y opening: e(C_y − v·G1, −G2)·e(W_y, [τ_Y − β]G2) == 1
    tau_minus_b = o.G2.add(srs.g2_tau_y,
                           o.G2.neg(o.G2.mul(srs.g2_gen, beta)))
    ok_y = native.pairing_check([
        (o.G1.add(C_y, o.G1.neg(o.G1.mul(g1, value))), o.G2.neg(srs.g2_gen)),
        (W_y, tau_minus_b),
    ])
    return ok_x and ok_y


# ---------------------------------------------------------------------------
# Validator-side RPC parity: random_poly / random_point / fft / eval
# (reference: neurons/validator.py:58-104)
# ---------------------------------------------------------------------------


def random_poly(srs: Srs, generator: torch.Generator) -> torch.Tensor:
    """Random bivariate polynomial as coefficient rows (M, T, 8) Montgomery.

    The samplers follow their generator's device and never the SRS's: for
    rows on the card pass ``torch.Generator(device="cuda")`` (a default
    ``torch.Generator()`` draws on the CPU)."""
    return _uniform_fr(generator, (srs.machines, srs.row_size))


def _uniform_fr(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniform Fr elements (Montgomery form): v = (a·2^256 + b) mod r from
    two 256-bit draws (statistical bias < 2^-256), on the generator's device.

    a·2^256 mod r = to_mont(a) read as canonical limbs; b mod r =
    from_mont(to_mont(b)). Their field sum is v, then re-encoded to
    Montgomery form (``zkp_subnet_tpu/models/pianist.py:220-233``).
    """
    def words():
        w = torch.randint(0, 1 << 32, tuple(shape) + (FR.L,),
                          generator=generator, device=generator.device,
                          dtype=torch.int64)
        return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)

    a_mod = FR.to_mont(words())                  # a·2^256 mod r (canonical)
    b_mod = FR.from_mont(FR.to_mont(words()))    # b mod r (canonical)
    return FR.to_mont(FR.add(a_mod, b_mod))


def random_point(generator: torch.Generator) -> torch.Tensor:
    """One uniform Fr element, Montgomery form, shape (8,), on the
    generator's device."""
    return _uniform_fr(generator, (1,))[0]


def fft(rows: torch.Tensor, left: bool = True,
        inverse: bool = False) -> torch.Tensor:
    """NTT/iNTT of the bivariate rows, matching ``fft(poly, left, inverse)``
    (reference: neurons/validator.py:58-65): left=True transforms along X
    (within each row), left=False along Y (across workers per column)."""
    if rows.dim() == 2:
        return tntt.ntt(rows, inverse=inverse)
    if left:
        return tntt.ntt_batch(rows, inverse=inverse)
    out = tntt.ntt_batch(rows.transpose(0, 1), inverse=inverse)
    return out.transpose(0, 1).contiguous()


def eval_poly(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Coefficient-form evaluation (reference: validator.py:97-104): one row
    (N, 8), or rows (R, N, 8) at the one point, by K3 ``fr_eval_rows`` on
    the card."""
    return tpoly.poly_eval(coeffs, x)
