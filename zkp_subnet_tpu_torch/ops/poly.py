"""Polynomial operations over Fr (coefficient form, c[0] = constant term).

The log-depth pipeline of ``zkp_subnet_tpu/ops/poly.py``, as glue over
kernel K3 (``fr_mul``/``fr_add``, ``csrc/fr.cu``) on the card and its plain
versions on the CPU. For one opening at x, with t_k = c_k·x^k:

    f(x) = S_0,  S_j = Σ_{k≥j} t_k   (Hillis-Steele suffix sums)
    q_j  = x^{-(j+1)}·S_{j+1}        (q = (f(X) − f(x))/(X − x))

Tensors are (N, 8) int32 Fr elements (Montgomery unless said otherwise),
fully reduced: the TPU's byte-lane layout (``ops/lane8.py``) that
``zkp_subnet_tpu/ops/poly.py`` converts to and from has no counterpart.
The inverse of the single challenge point is a host ``pow(x, r−2, r)``.
"""

from __future__ import annotations

import torch

from .field import FR, fr_add, fr_mul


def _one_canonical(device) -> torch.Tensor:
    """The integer 1 as limbs: a Montgomery multiply by it de-Montgomerizes."""
    return FR.ints_to_limbs([1], device)


def _suffix_sums(terms: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix sums, Hillis-Steele: log2(N) elementwise adds
    (``zkp_subnet_tpu/ops/poly.py:62-72``); the shifted-in identity is 0."""
    n = terms.shape[0]
    d = 1
    while d < n:
        shifted = torch.cat([terms[d:], FR.zeros((d,), terms.device)])
        terms = fr_add(terms, shifted)
        d <<= 1
    return terms


def _inverse(x: torch.Tensor) -> torch.Tensor:
    """1/x (0 ↦ 0) of one Montgomery element, on the host."""
    xi = FR.decode(x.reshape(1, FR.L))[0]
    return FR.encode([pow(xi, FR.p - 2, FR.p)], x.device)[0]


def _open_pieces(coeffs: torch.Tensor, x: torch.Tensor):
    """(y, q') with q'_j = x^{-(j+1)}·S_{j+1} at full width n (q'_{n−1} = 0)."""
    n = coeffs.shape[0]
    terms = fr_mul(coeffs, FR.powers(x, n))         # t_k = c_k·x^k
    suffix = _suffix_sums(terms)
    xi = _inverse(x).reshape(1, FR.L)
    inv_pw = fr_mul(FR.powers(xi, n), xi)           # x^{-1} .. x^{-n}
    s_next = torch.cat([suffix[1:], FR.zeros((1,), coeffs.device)])
    return suffix[0], fr_mul(s_next, inv_pw)


def poly_eval(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f(x). coeffs (N, 8) Montgomery; x (8,). Returns (8,)."""
    terms = fr_mul(coeffs, FR.powers(x, coeffs.shape[0]))
    return _suffix_sums(terms)[0]


def poly_eval_and_quotient(coeffs: torch.Tensor, x: torch.Tensor):
    """(f(x), q) with q(X) = (f(X) − f(x))/(X − x), shape (N−1, 8), both
    Montgomery. At x = 0 the quotient is c[1:]
    (``zkp_subnet_tpu/ops/poly.py:103-132``)."""
    y, q = _open_pieces(coeffs, x)
    if bool(FR.is_zero(x)):
        return y, coeffs[1:]
    return y, q[:-1]


def poly_open_scalars(coeffs: torch.Tensor, x: torch.Tensor):
    """(f(x) Montgomery (8,), quotient scalars (N, 8) CANONICAL, q[N−1] = 0)
    for a KZG opening (``zkp_subnet_tpu/ops/poly.py:140-172``).

    The x = 0 corner stays exact: the quotient is then c[1:] (a commit-only
    request runs the opening with x = 0)."""
    y, q = _open_pieces(coeffs, x)
    if bool(FR.is_zero(x)):
        q = torch.cat([coeffs[1:], FR.zeros((1,), coeffs.device)])
    return y, from_mont_wide(q)


def from_mont_wide(coeffs: torch.Tensor) -> torch.Tensor:
    """(N, 8) Montgomery → canonical: one K3 multiply by the integer 1
    (``zkp_subnet_tpu/ops/poly.py:184-191``)."""
    return fr_mul(coeffs, _one_canonical(coeffs.device))
