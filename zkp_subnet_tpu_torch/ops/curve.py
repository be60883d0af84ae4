"""BLS12-381 G1 on torch tensors.

Points are ``(..., 3, 12)`` int32 tensors: homogeneous projective (X : Y : Z)
over Fq in Montgomery form, infinity (0 : R mod q : 0), as in
``zkp_subnet_tpu/ops/curve.py:31-36``. ``g1_add``/``g1_double`` are the
complete RCB15 formulas (eprint 2015/1060, Algorithms 7 and 9, a = 0):
kernel K1 (``csrc/g1.cu``) on a CUDA tensor, ``g1_add_plain``/
``g1_double_plain`` on a CPU tensor. Both evaluate the same field-op
sequence as the JAX package, so even the projective outputs agree.
``g1_scalar_mul`` is the ladder over signed 4-bit windows as one K1 launch
on a CUDA tensor (``g1_scalar_mul_plain``, the kernel's doubles and adds in
its order, on a CPU tensor). ``g1_sum`` is a glue loop over the add, and so is the
fixed-base comb ``g1_fixed_base_mul`` (a table gather and one K1 add per
8-bit window), which generates the SRS.

The TPU's byte-limb (``ops/lane8.py``) and lazy signed-digit
(``ops/lazy8.py``) point engines have no counterpart: coordinates stay
fully reduced Montgomery values (CIOS on u32 limbs in ``csrc/g1.cuh``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from . import kernels
from .field import FQ, FR, narrow, widen
from ..utils import oracle as o

_B3 = 12  # 3·b for y² = x³ + 4


def g1_infinity(shape=(), device=None) -> torch.Tensor:
    """(0 : 1 : 0) broadcast to shape + (3, 12)."""
    out = torch.zeros(tuple(shape) + (3, FQ.L), dtype=torch.int32,
                      device=device)
    out[..., 1, :] = FQ.ones((), device)
    return out


def g1_pack(x, y, z) -> torch.Tensor:
    return torch.stack([x, y, z], dim=-2)


def g1_unpack(p):
    return p[..., 0, :], p[..., 1, :], p[..., 2, :]


def g1_encode(points: Sequence, device=None) -> torch.Tensor:
    """Oracle points (Jacobian int tuples) → (N, 3, 12) tensor, Z ∈ {0, 1}."""
    xs, ys, zs = [], [], []
    for p in points:
        a = o.G1.to_affine(p)
        if a is None:
            xs.append(0); ys.append(1); zs.append(0)
        else:
            xs.append(a[0]); ys.append(a[1]); zs.append(1)
    return g1_pack(FQ.encode(xs, device), FQ.encode(ys, device),
                   FQ.encode(zs, device))


def g1_decode(p: torch.Tensor) -> List:
    """(..., 3, 12) tensor → list of oracle Jacobian points."""
    flat = p.reshape(-1, 3, FQ.L)
    xs = FQ.decode(flat[:, 0])
    ys = FQ.decode(flat[:, 1])
    zs = FQ.decode(flat[:, 2])
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(o.G1.infinity())
        else:
            zinv = o.fq_inv(z)
            out.append(o.G1.from_affine((x * zinv % o.Q, y * zinv % o.Q)))
    return out


def g1_affine(p: torch.Tensor) -> List:
    """(..., 3, 12) tensor → affine int pairs (None for infinity)."""
    return [o.G1.to_affine(q) for q in g1_decode(p)]


# -- plain versions of K1 (int64, 16-bit limbs) --------------------------------

_mul, _add, _sub = FQ.mul16, FQ.add16, FQ.sub16


def _stk(*xs):
    return torch.stack(torch.broadcast_tensors(*xs), dim=0)


def _b3(like):
    return widen(FQ.encode([_B3], like.device)[0])


def g1_add_plain(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain version of K1 ``g1_add``: RCB15 Algorithm 7 with the independent
    products of each layer stacked into one batched multiply, as
    ``zkp_subnet_tpu/ops/curve.py:80-116`` does."""
    p, q = torch.broadcast_tensors(p, q)
    X1, Y1, Z1 = (widen(c) for c in g1_unpack(p))
    X2, Y2, Z2 = (widen(c) for c in g1_unpack(q))
    b3 = _b3(p)
    a1, a2, a3, a4, a5, a6 = _add(_stk(X1, X2, Y1, Y2, X1, X2),
                                  _stk(Y1, Y2, Z1, Z2, Z1, Z2))
    t0, t1, t2, p1, p2, p3 = _mul(_stk(X1, Y1, Z1, a1, a3, a5),
                                  _stk(X2, Y2, Z2, a2, a4, a6))
    s1, s2, s3, dbl0 = _add(_stk(t0, t1, t0, t0), _stk(t1, t2, t2, t0))
    t3, t4, ty = _sub(_stk(p1, p2, p3), _stk(s1, s2, s3))
    t2b, y3b = _mul(_stk(t2, ty), b3)
    z3t, t0t = _add(_stk(t1, dbl0), _stk(t2b, t0))
    t1t = _sub(t1, t2b)
    w0, w1, w2, w3, w4, w5 = _mul(_stk(t3, t4, y3b, t1t, z3t, t0t),
                                  _stk(t1t, y3b, t0t, z3t, t4, t3))
    X3 = _sub(w0, w1)
    Y3, Z3 = _add(_stk(w2, w4), _stk(w3, w5))
    return g1_pack(narrow(X3), narrow(Y3), narrow(Z3))


def g1_double_plain(p: torch.Tensor) -> torch.Tensor:
    """Plain version of K1 ``g1_double``: RCB15 Algorithm 9, layer-batched as
    ``zkp_subnet_tpu/ops/curve.py:119-139``."""
    X, Y, Z = (widen(c) for c in g1_unpack(p))
    b3 = _b3(p)
    t0, tyz, tzz, txy = _mul(_stk(Y, Y, Z, X), _stk(Y, Z, Z, Y))
    d1 = _add(t0, t0)
    d2 = _add(d1, d1)
    z8 = _add(d2, d2)                                 # 8·Y²
    t2b = _mul(tzz, b3)                               # 3b·Z²
    y3a, t1c = _add(_stk(t0, t2b), _stk(t2b, t2b))
    t2c = _add(t1c, t2b)                              # 9b·Z²
    t0b = _sub(t0, t2c)
    x3m, z3, y3m, x3o = _mul(_stk(t2b, tyz, t0b, t0b),
                             _stk(z8, z8, y3a, txy))
    Y3 = _add(x3m, y3m)
    X3 = _add(x3o, x3o)
    return g1_pack(narrow(X3), narrow(Y3), narrow(z3))


# -- K1 dispatch and the glue built on it --------------------------------------

def g1_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete add: K1 on a CUDA tensor, the plain version on the CPU."""
    if p.is_cuda or q.is_cuda:
        return kernels.g1_add(p, q)
    return g1_add_plain(p, q)


def g1_double(p: torch.Tensor) -> torch.Tensor:
    """Complete double: K1 on a CUDA tensor, the plain version on the CPU."""
    if p.is_cuda:
        return kernels.g1_double(p)
    return g1_double_plain(p)


def g1_neg(p: torch.Tensor) -> torch.Tensor:
    """−P: (X : −Y : Z), the negation by K4 ``fq_sub`` on a CUDA tensor."""
    X, Y, Z = g1_unpack(p)
    return g1_pack(X, FQ.neg(Y), Z)


def g1_select(cond: torch.Tensor, p: torch.Tensor, q: torch.Tensor):
    """cond ? p : q, with cond shaped like the points' batch dims."""
    return torch.where(cond[..., None, None], p, q)


#: the ladder's signed windows (LADDER_DIGIT_BITS of csrc/g1.cuh): digits
#: in [-7, 8], a table of the multiples P … 8P a point
LADDER_DIGIT_BITS = 4
LADDER_WINDOWS = -(-256 // LADDER_DIGIT_BITS)
LADDER_MULTIPLES = 1 << (LADDER_DIGIT_BITS - 1)


def signed_digits(scalars: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., 8) canonical scalars (any 256-bit value) → (..., W + 1) int64,
    W = ceil(256 / bits): the signed digits of ``bits``-bit windows in
    [1 − 2^(bits−1), 2^(bits−1)], least significant first (each window's
    bits plus the carry out of the one below, less 2^bits and a carry out
    where that passes 2^(bits−1)), then the carry out of the top window:
    k = carry·2^(bits·W) + Σ d_w·2^(bits·w). ``csrc/g1.cuh:signed_digit``
    computes each digit alone."""
    s = scalars.to(torch.int64) & 0xFFFFFFFF
    pos = torch.arange(32, device=scalars.device)
    flat = ((s.unsqueeze(-1) >> pos) & 1).flatten(-2)       # (..., 256)
    windows = -(-256 // bits)
    pad = windows * bits - 256
    if pad:
        flat = torch.cat([flat, flat.new_zeros(flat.shape[:-1] + (pad,))],
                         -1)
    weights = 1 << torch.arange(bits, device=scalars.device)
    nib = (flat.unflatten(-1, (windows, bits)) * weights).sum(-1)
    out = torch.empty(nib.shape[:-1] + (windows + 1,), dtype=torch.int64,
                      device=scalars.device)
    carry = torch.zeros_like(nib[..., 0])
    for w in range(windows):
        d = nib[..., w] + carry
        carry = (d > 1 << (bits - 1)).long()
        out[..., w] = d - (carry << bits)
    out[..., windows] = carry
    return out


def ladder_table_plain(p: torch.Tensor) -> torch.Tensor:
    """(N, 3, 12) → (N, LADDER_MULTIPLES, 3, 12), entry j = (j + 1)P, as the
    kernel builds it: an even multiple m by a double of m/2, an odd one by
    an add of P to m − 1."""
    table = [p]
    for m in range(2, LADDER_MULTIPLES + 1):
        table.append(g1_double_plain(table[m // 2 - 1]) if m % 2 == 0
                     else g1_add_plain(table[m - 2], p))
    return torch.stack(table, 1)


def g1_scalar_mul_plain(p: torch.Tensor,
                        scalars: torch.Tensor) -> torch.Tensor:
    """Plain version of K1 ``g1_scalar_mul``, its operations in its order:
    the signed digits of 4-bit windows (``signed_digits``), the table P …
    8P (``ladder_table_plain``), acc = P where the top window carries out,
    else ∞; then from the top window down 4 doubles and, where the digit d
    is not 0, one add of entry |d| − 1, its Y negated where d < 0, every
    point at once. The top window's doubles of ∞ are (0 : 1 : 0) limb for
    limb, so they run only where a point carries."""
    shape = p.shape
    p = p.reshape(-1, 3, FQ.L)
    d = signed_digits(scalars.reshape(-1, FR.L), LADDER_DIGIT_BITS)
    table = ladder_table_plain(p)
    rows = torch.arange(p.shape[0], device=p.device)
    carry = d[:, LADDER_WINDOWS] != 0
    acc = g1_select(carry, p, g1_infinity((p.shape[0],), p.device))
    for w in range(LADDER_WINDOWS - 1, -1, -1):
        if w < LADDER_WINDOWS - 1 or bool(carry.any()):
            for _ in range(LADDER_DIGIT_BITS):
                acc = g1_double_plain(acc)
        dw = d[:, w]
        entry = table[rows, (dw.abs() - 1).clamp(min=0)]
        entry[:, 1] = torch.where((dw < 0)[:, None], FQ.sub_plain(
            torch.zeros_like(entry[:, 1]), entry[:, 1]), entry[:, 1])
        acc = g1_select(dw != 0, g1_add_plain(acc, entry), acc)
    return acc.reshape(shape)


def g1_scalar_mul(p: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """[k_i]P_i. p: (N, 3, 12); scalars: (N, 8) canonical int32 limbs (any
    256-bit value). One K1 launch for the whole ladder on a CUDA tensor,
    the plain version on the CPU."""
    if p.is_cuda or scalars.is_cuda:
        return kernels.g1_scalar_mul(p.contiguous(), scalars.contiguous())
    return g1_scalar_mul_plain(p, scalars)


def scalar_digits(scalars: torch.Tensor, window_bits: int) -> torch.Tensor:
    """(N, 8) int32 canonical scalars → (N, 256/w) int64 w-bit digits, least
    significant window first."""
    s = scalars.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(0, 32, window_bits, device=scalars.device)
    return ((s.unsqueeze(-1) >> shifts)
            & ((1 << window_bits) - 1)).flatten(-2)


#: the comb's window width: W = 32 windows of D = 256 multiples of G, the
#: only width the port's callers use
COMB_WINDOW_BITS = 8

_tables_cache = {}


def g1_fixed_base_tables(window_bits: int = COMB_WINDOW_BITS,
                         device=None) -> torch.Tensor:
    """Generator multiples for the fixed-base comb: tables[j, d] =
    [d·2^(8·j)]G, shape (32, 256, 3, 12).

    Built once on the host oracle, as
    ``zkp_subnet_tpu/ops/curve.py:184-206`` builds them (so the entries are
    the same affine points with Z = 1, limb for limb), then moved to
    ``device`` and kept per device. ``window_bits`` keeps the JAX
    signature; only 8 is built."""
    if window_bits != COMB_WINDOW_BITS:
        raise ValueError(f"window_bits must be {COMB_WINDOW_BITS}")
    device = torch.device(device or "cpu")
    key = str(device)
    if key not in _tables_cache:
        host = _tables_cache.get("cpu")
        if host is None:
            W, D = 256 // COMB_WINDOW_BITS, 1 << COMB_WINDOW_BITS
            base = o.G1.from_affine(o.G1_GEN)
            pts = []
            for _ in range(W):
                row = [o.G1.infinity()]
                for _ in range(D - 1):
                    row.append(o.G1.add(row[-1], base))
                pts.extend(row)
                for _ in range(COMB_WINDOW_BITS):
                    base = o.G1.double(base)
            host = g1_encode(pts).reshape(W, D, 3, FQ.L)
            _tables_cache["cpu"] = host
        _tables_cache[key] = host.to(device)
    return _tables_cache[key]


def g1_fixed_base_mul(tables: torch.Tensor,
                      scalars: torch.Tensor) -> torch.Tensor:
    """[k_i]G by the comb: (32, 256, 3, 12) tables and (N, 8) canonical
    int32 scalars → (N, 3, 12).

    Windows j = 0..31 in that order from infinity; each step gathers the
    table rows of the window's digits and adds them with one complete add
    (K1 ``g1_add`` on the card), the order of
    ``zkp_subnet_tpu/ops/curve.py:209-239``, so the projective result is
    the same limb for limb."""
    digits = scalar_digits(scalars, COMB_WINDOW_BITS)          # (N, 32)
    acc = g1_infinity((scalars.shape[0],), scalars.device)
    for j in range(tables.shape[0]):
        acc = g1_add(acc, tables[j].index_select(0, digits[:, j]))
    return acc


def tree_sum(t: torch.Tensor, add, zero: torch.Tensor) -> torch.Tensor:
    """Σ along dim 1 of a (B, N, ...) tensor of elements → (B, ...), by a
    halving tree of ``add`` over the contiguous halves, padded with
    ``zero`` (one element) to a power of two: ``g1_sum``'s points, and the
    aggregation's points and Fr elements a challenge."""
    b, n = t.shape[:2]
    target = 1 << max(0, (n - 1).bit_length())
    if target != n:
        t = torch.cat([t, zero.expand((b, target - n) + zero.shape)], 1)
    while t.shape[1] > 1:
        half = t.shape[1] // 2
        t = add(t[:, :half].contiguous(), t[:, half:].contiguous())
    return t[:, 0]


def g1_sum(points: torch.Tensor) -> torch.Tensor:
    """Σ of an (N, 3, 12) tensor → (3, 12), by ``tree_sum``'s tree of
    adds."""
    return tree_sum(points[None], g1_add, g1_infinity((), points.device))[0]


def fr_to_scalar_limbs(xs: Sequence[int], device=None) -> torch.Tensor:
    """Host scalars → (N, 8) canonical (non-Montgomery) int32 limbs."""
    return FR.ints_to_limbs([int(x) % o.R for x in xs], device)
