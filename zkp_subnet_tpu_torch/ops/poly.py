"""Polynomial operations over Fr (coefficient form, c[0] = constant term).

The log-depth pipeline of ``zkp_subnet_tpu/ops/poly.py``. For one opening
at x, with t_k = c_k·x^k:

    f(x) = S_0,  S_j = Σ_{k≥j} t_k   (suffix sums)
    q_j  = x^{-(j+1)}·S_{j+1}        (q = (f(X) − f(x))/(X − x))

``poly_open_scalars`` opens one row or B rows at one x (a prove's rows all
open at α). On a CUDA tensor that is five launches of kernel K3
(``csrc/fr.cu``) whatever B, and nothing read back to the host:
``fr_inv`` (1/x; skipped where the caller hands 1/x in),
``fr_power_tables`` (the tables of powers of x and of 1/x, once for all
rows), ``fr_powers`` (the terms t_k of every row), ``fr_suffix_scan`` (each
tile's suffix sums and total, over the rows laid end to end where n is a
multiple of the tile, else once a row) and ``fr_open_quotient`` (the carry
over a row's tiles, y = S_0, the scaled quotient, the x = 0 corner). Their
plain versions (``fr_inv_plain``, ``fr_power_tables_plain``,
``fr_powers_plain``, ``fr_suffix_scan_plain``, ``fr_open_quotient_plain``,
composed by ``open_pieces_plain``) follow the kernels' method and take the
tile and the tables' level width as arguments. On a CPU tensor the opening
is the JAX package's composition over the plain Fr ops: powers by
doubling, Hillis-Steele suffix sums, the inverse by ``FR.inv``.

An evaluation alone (``poly_eval``, ``poly_eval_many``: one row or a batch
of rows, as the coordinator's challenge evaluates all its rows at α) is
one call of K3 ``fr_eval_rows`` on a CUDA tensor, and its plain version
``fr_eval_rows_plain`` on a CPU one: the sum of c_k·x^k over tiles, with no
inverse and no quotient: Horner runs at a warp's stride and trees of Horner
steps, about one product an element.

Tensors are (N, 8) int32 Fr elements (Montgomery unless said otherwise),
fully reduced: the TPU's byte-lane layout (``ops/lane8.py``) that
``zkp_subnet_tpu/ops/poly.py`` converts to and from has no counterpart.
"""

from __future__ import annotations

import torch

from . import kernels
from .curve import tree_sum
from .field import (FR, fr_add, fr_inv_plain, fr_mul, fr_power_tables_plain,
                    fr_powers_plain, table_pow_plain)

#: elements of one tile of the suffix scan (the kernel's; CPU tests pass
#: smaller tiles to the plain versions)
SCAN_TILE = kernels.SCAN_TILE

#: elements of one tile of the row evaluation (the kernel's), and the
#: stride of a lane's Horner run in it (a warp's lanes)
EVAL_TILE = kernels.EVAL_TILE
EVAL_STRIDE = 32

#: entries of a level of the power tables (the kernel's; CPU tests pass
#: smaller widths to the plain versions)
POW_WIDTH = kernels.POW_WIDTH


def _one_canonical(device) -> torch.Tensor:
    """The integer 1 as limbs: a Montgomery multiply by it de-Montgomerizes."""
    return FR.ints_to_limbs([1], device)


def _scan_from_right(terms: torch.Tensor, add) -> torch.Tensor:
    """Inclusive suffix sums along dim −2, Hillis-Steele: log2 of its length
    elementwise adds (``zkp_subnet_tpu/ops/poly.py:62-72``); the shifted-in
    identity is 0."""
    n = terms.shape[-2]
    d = 1
    while d < n:
        zeros = FR.zeros(terms.shape[:-2] + (d,), terms.device)
        terms = add(terms, torch.cat([terms[..., d:, :], zeros], dim=-2))
        d <<= 1
    return terms


def _open_pieces(coeffs: torch.Tensor, x: torch.Tensor, xi=None):
    """(y, q') with q'_j = x^{-(j+1)}·S_{j+1} at full width n (q'_{n−1} = 0)
    for coeffs (..., n, 8), every row at x, composed over the elementwise Fr
    ops (the CPU's path); ``xi`` = 1/x where the caller has it."""
    n = coeffs.shape[-2]
    terms = fr_mul(coeffs, FR.powers(x, n))         # t_k = c_k·x^k
    suffix = _scan_from_right(terms, fr_add)
    xi = (FR.inv(x) if xi is None else xi).reshape(1, FR.L)   # 0 ↦ 0
    inv_pw = fr_mul(FR.powers(xi, n), xi)           # x^{-1} .. x^{-n}
    zero = FR.zeros(coeffs.shape[:-2] + (1,), coeffs.device)
    s_next = torch.cat([suffix[..., 1:, :], zero], dim=-2)
    return suffix[..., 0, :], fr_mul(s_next, inv_pw)


def _scan_on_card(terms: torch.Tensor):
    """``fr_suffix_scan`` of B rows (B, n, 8): (local (B, n, 8), totals (B,
    tiles, 8)). Its tiles are tile-local, so one launch over the rows laid
    end to end where they are whole tiles (or one row), else one a row."""
    b, n = terms.shape[:2]
    if b == 1 or n % SCAN_TILE == 0:
        local, totals = kernels.fr_suffix_scan(terms.view(b * n, FR.L))
        return local.view(b, n, FR.L), totals.view(b, -1, FR.L)
    pairs = [kernels.fr_suffix_scan(t) for t in terms]
    return (torch.stack([p[0] for p in pairs]),
            torch.stack([p[1] for p in pairs]))


def _open_on_card(coeffs: torch.Tensor, x: torch.Tensor, xi=None):
    """(y Montgomery, q canonical) of ``fr_open_quotient`` for one row (n,
    8) or B rows (B, n, 8) at x, in five K3 launches whatever B, four where
    the caller hands over ``xi`` = 1/x; x stays on the card."""
    rows = coeffs if coeffs.dim() == 3 else coeffs[None]
    rows, x = rows.contiguous(), x.contiguous()
    n = rows.shape[1]
    xi = kernels.fr_inv(x) if xi is None else xi.contiguous()
    tables = kernels.fr_power_tables(x, n, xi)
    local, totals = _scan_on_card(kernels.fr_powers(tables[0], n, rows))
    y, q = kernels.fr_open_quotient(local, totals, x, tables[1], rows)
    return (y, q) if coeffs.dim() == 3 else (y[0], q[0])


# -- plain versions of the scan kernels ---------------------------------------

def fr_suffix_scan_plain(terms: torch.Tensor, tile: int = SCAN_TILE):
    """Plain version of K3 ``fr_suffix_scan``: (local, totals), each tile's
    inclusive suffix sums from its right end and its total (the first local
    sum), over tiles of ``tile`` elements, of (n, 8) terms or of each row of
    (B, n, 8). Inside a tile the adds go in Hillis-Steele's order, not the
    kernel's (a thread's elements, its warp, the warps): the sums are the
    same limbs."""
    lead, n = terms.shape[:-2], terms.shape[-2]
    blocks = -(-n // tile)
    pad = FR.zeros(lead + (blocks * tile - n,), terms.device)
    padded = torch.cat([terms, pad], dim=-2)
    sums = _scan_from_right(padded.view(lead + (blocks, tile, FR.L)),
                            FR.add_plain)
    return (sums.reshape(lead + (-1, FR.L))[..., :n, :],
            sums[..., 0, :].contiguous())


def fr_open_quotient_plain(local: torch.Tensor, totals: torch.Tensor,
                           x: torch.Tensor, xi_table: torch.Tensor,
                           coeffs: torch.Tensor, tile: int = SCAN_TILE):
    """Plain version of K3 ``fr_open_quotient`` over one row (n, 8) or B
    rows (B, n, 8) at x: (y Montgomery, q canonical) from the first pass's
    tiles. carry_b = Σ_{b' > b} totals[b'] of the row; S_{j+1} = local_{j+1}
    + carry inside a tile, the carry alone at a tile's last element; y =
    S_0, q_j = S_{j+1}·xi^(j+1) for j < n − 1 with xi^(j+1) looked up in
    1/x's table (``xi_table``, level 0 canonical, so q is), q_{n−1} = 0;
    at x = 0, q = c[1:] ‖ 0 times the integer 1."""
    n, dev = local.shape[-2], local.device
    lead = local.shape[:-2]
    zero = FR.zeros(lead + (1,), dev)
    carry = _scan_from_right(torch.cat([totals[..., 1:, :], zero], dim=-2),
                             FR.add_plain)
    j = torch.arange(n, device=dev)
    block = j // tile
    inside = j + 1 < torch.clamp((block + 1) * tile, max=n)
    nxt = torch.where(inside[:, None],
                      torch.cat([local[..., 1:, :], zero], dim=-2), 0)
    s_next = FR.add_plain(nxt, carry[..., block, :])
    y = FR.add_plain(local[..., 0, :], carry[..., 0, :])
    pw = table_pow_plain(xi_table, torch.clamp(j + 1, max=max(n - 1, 0)))
    q = torch.where((j + 1 < n)[:, None], FR.mont_mul_plain(s_next, pw), 0)
    one = _one_canonical(dev)
    q_zero = FR.mont_mul_plain(torch.cat([coeffs[..., 1:, :], zero], dim=-2),
                               one)
    at_zero = bool(FR.is_zero(x.reshape(FR.L)))
    return y, q_zero if at_zero else q


def open_pieces_plain(coeffs: torch.Tensor, x: torch.Tensor,
                      tile: int = SCAN_TILE, xi=None, width: int = POW_WIDTH):
    """The plain versions composed as ``_open_on_card`` launches the
    kernels, for one row (n, 8) or B rows (B, n, 8) at x: (y, q);
    ``fr_inv_plain`` is skipped where ``xi`` = 1/x is given. ``tile`` and
    ``width``: the scan's tile and the tables' level width."""
    n = coeffs.shape[-2]
    xi = fr_inv_plain(x.reshape(FR.L)) if xi is None else xi.reshape(FR.L)
    tables = fr_power_tables_plain(x, n, xi, width)
    terms = fr_powers_plain(tables[0], n, coeffs)
    local, totals = fr_suffix_scan_plain(terms, tile)
    return fr_open_quotient_plain(local, totals, x, tables[1], coeffs, tile)


def fr_eval_rows_plain(coeffs: torch.Tensor, xs: torch.Tensor,
                       tile: int = EVAL_TILE):
    """Plain version of K3 ``fr_eval_rows``: y_r = Σ_k c_{r,k}·x_r^k, (R, 8)
    Montgomery, from ``coeffs`` (R, n, 8) and ``xs`` (R, 8), either of
    which may hold one row or one point for all R. As the kernel: each tile
    of ``tile`` elements by Horner runs at the stride of a warp's lanes,
    then the tree that joins the runs (``_horner_join``), into the tile's
    partial sum; then the row's partials the same way at x^tile. Inside a
    tile the kernel splits the runs over its warps, weights a warp's lanes
    by x^lane and joins its warps by the tree: the sums are exact, so the
    limbs are the same."""
    rows = max(coeffs.shape[0], xs.shape[0])
    n = coeffs.shape[1]
    tiles = -(-n // tile)
    c = coeffs.expand(rows, n, FR.L)
    x = xs.expand(rows, FR.L)
    pad = FR.zeros((rows, tiles * tile - n), c.device)
    parts = _horner_join(torch.cat([c, pad], 1).view(rows * tiles, tile,
                                                     FR.L),
                         x.repeat_interleave(tiles, 0))
    return _horner_join(parts.view(rows, tiles, FR.L), _pow_plain(x, tile))


def _pow_plain(x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e (Montgomery) of (B, 8) x by square-and-multiply, plain."""
    out = FR.ones(x.shape[:-1], x.device)
    for bit in bin(e)[2:]:
        out = FR.mont_mul_plain(out, out)
        if bit == "1":
            out = FR.mont_mul_plain(out, x)
    return out


def _horner_join(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Σ_j v_j·x^j of (B, m, 8) values at (B, 8) points, as ``fr_eval_rows``
    joins them: lane l of EVAL_STRIDE takes v_(l + 32i) by Horner's steps
    from the top with x^32, then a tree of Horner steps joins the lanes,
    the pair (l, l + d) into h_l + x^d·h_(l+d) (``curve.tree_sum``'s
    halving tree, whose halves are d apart)."""
    b, m = v.shape[:2]
    steps = -(-m // EVAL_STRIDE)
    pad = FR.zeros((b, steps * EVAL_STRIDE - m), v.device)
    runs = torch.cat([v, pad], 1).view(b, steps, EVAL_STRIDE, FR.L)
    xd = {1: x[:, None]}                          # x^d, d = 1 .. 32
    while len(xd) <= EVAL_STRIDE.bit_length() - 1:
        d = 1 << len(xd)
        xd[d] = FR.mont_mul_plain(xd[d // 2], xd[d // 2])
    h = runs[:, -1]
    for i in range(steps - 2, -1, -1):
        h = FR.add_plain(FR.mont_mul_plain(h, xd[EVAL_STRIDE]), runs[:, i])
    return tree_sum(h, lambda lo, hi: FR.add_plain(
        lo, FR.mont_mul_plain(hi, xd[lo.shape[1]])), FR.zeros((), v.device))


def _eval_rows(coeffs: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    if coeffs.is_cuda or xs.is_cuda:
        return kernels.fr_eval_rows(coeffs.contiguous(), xs.contiguous())
    return fr_eval_rows_plain(coeffs, xs)


# -- public ops --------------------------------------------------------------

def poly_eval(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f(x). coeffs (N, 8) Montgomery, or a batch (R, N, 8) of rows all at
    the one point (the coordinator's ``jax.vmap`` of ``poly_eval``,
    ``zkp_subnet_tpu/runtime/coordinator.py:91``, as a dimension); x (8,).
    Returns (8,), or (R, 8) for a batch."""
    if coeffs.dim() == 3:
        return _eval_rows(coeffs, x.reshape(1, FR.L))
    return _eval_rows(coeffs[None], x.reshape(1, FR.L))[0]


def poly_eval_many(coeffs: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """One polynomial at many points: coeffs (N, 8), xs (B, 8) → (B, 8)
    (``zkp_subnet_tpu/ops/poly.py:98-100``)."""
    return _eval_rows(coeffs[None], xs.reshape(-1, FR.L))


def poly_eval_and_quotient(coeffs: torch.Tensor, x: torch.Tensor):
    """(f(x), q) with q(X) = (f(X) − f(x))/(X − x), shape (N−1, 8), both
    Montgomery. At x = 0 the quotient is c[1:]
    (``zkp_subnet_tpu/ops/poly.py:103-132``)."""
    if coeffs.is_cuda:
        y, q = _open_on_card(coeffs, x)
        return y, FR.to_mont(q[:-1])
    y, q = _open_pieces(coeffs, x)
    if bool(FR.is_zero(x)):
        return y, coeffs[1:]
    return y, q[:-1]


def poly_quotient(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """q(X) = (f(X) − f(x))/(X − x), (N−1, 8) Montgomery
    (``zkp_subnet_tpu/ops/poly.py:135-137``)."""
    return poly_eval_and_quotient(coeffs, x)[1]


def poly_open_scalars(coeffs: torch.Tensor, x: torch.Tensor, xi=None):
    """(f(x) Montgomery (8,), quotient scalars (N, 8) CANONICAL, q[N−1] = 0)
    for a KZG opening (``zkp_subnet_tpu/ops/poly.py:140-172``); for B rows
    (B, N, 8) at the one x, (B, 8) and (B, N, 8): on the card the same five
    launches as one row (the tables of x and 1/x built once for all).

    ``xi``: 1/x (Montgomery, ``FR.inv(x)``) where the caller has it; else
    the opening inverts x itself (one K3 ``fr_inv`` on the card). The x = 0
    corner stays exact: the quotient is then c[1:] (a commit-only request
    runs the opening with x = 0). On the card that choice is made by the
    kernel, so x is never read back to the host."""
    if coeffs.is_cuda:
        return _open_on_card(coeffs, x, xi)
    y, q = _open_pieces(coeffs, x, xi)
    if bool(FR.is_zero(x)):
        zero = FR.zeros(coeffs.shape[:-2] + (1,), coeffs.device)
        q = torch.cat([coeffs[..., 1:, :], zero], dim=-2)
    return y, from_mont_wide(q)


def poly_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Coefficientwise a + b (``zkp_subnet_tpu/ops/poly.py:175-176``)."""
    return FR.add(a, b)


def poly_scale(coeffs: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Every coefficient times the scalar k (8,), Montgomery: one K3
    ``fr_mul`` with k broadcast (``zkp_subnet_tpu/ops/poly.py:179-181``)."""
    return FR.mont_mul(coeffs, k.reshape(FR.L))


def from_mont_wide(coeffs: torch.Tensor) -> torch.Tensor:
    """(N, 8) Montgomery → canonical: one K3 multiply by the integer 1
    (``zkp_subnet_tpu/ops/poly.py:184-191``)."""
    return fr_mul(coeffs, _one_canonical(coeffs.device))
