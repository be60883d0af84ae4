"""The plain reference of one Pianist prove round.

What every output of a round has to be, worked out again from the round's
inputs (the challenge's rows of evaluations, alpha, beta) and the trapdoor
(tau_x, tau_y) that the benchmark drew from the seed. It imports nothing of
the system under test: BLS12-381 constants, the field arithmetic (Python
integers), G1 in Jacobian coordinates and a fixed-base comb for the
generator are written out here; dot products of whole rows run as exact
float64 matrix products of 16-bit limbs in plain PyTorch.

The definitions it holds the program to (M workers, rows of T, the M-point
and T-point domains of the roots of unity of BLS12-381's Fr, L_i the
Lagrange basis of the M-point domain):

- coefficients of row i: those of the polynomial f_i of degree < T that
  the traffic's inverse NTTs make of the evaluations E (M rows of T):
  within each row (``x``), f_i takes the values E_i on the T-point domain;
  across the workers (``y``), f_i = (1/M) sum_k w^(-ik) g_k, w the M-point
  domain's root and g_k the row k's polynomial before it (its values, or
  where ``x`` is not run its words read as coefficients);
- commitment i: [L_i(tau_y) * f_i(tau_x)] G1;
- evaluation i: y_i = f_i(alpha);
- opening i: [L_i(tau_y) * (f_i(tau_x) - y_i) / (tau_x - alpha)] G1;
- aggregate: C = [F] G1 with F = sum_i L_i(tau_y) f_i(tau_x);
  W = [(F - Y) / (tau_x - alpha)] G1 with Y = sum_i L_i(tau_y) y_i;
  C_y = [Y] G1; value v = sum_i L_i(beta) y_i;
  W_y = [(Y - v) / (tau_y - beta)] G1;
- SRS: g1_x[j] = [tau_x^j] G1; worker_bases[i][j] = [L_i(tau_y) tau_x^j] G1;
  lagrange_y[i] = [L_i(tau_y)] G1.

f_i(x) at any point comes from the evaluations (by the barycentric formula
where ``x`` is run), never from the program's coefficients. Elements
travel as the program's words: an Fr element as 8 little-endian 32-bit
words of its Montgomery form (value * 2^256 mod r), a G1 point as X, Y, Z
of 12 words each, homogeneous projective over Fq in Montgomery form
(value * 2^384 mod q).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

#: BLS12-381: the scalar field's modulus r, the base field's q, G1's
#: generator, Fr's multiplicative generator and two-adicity
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
Q = int("1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F624"
        "1EABFFFEB153FFFFB9FEFFFFFFFFAAAB", 16)
G1_X = int("17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC5"
           "86C55E83FF97A1AEFFB3AF00ADB22C6BB", 16)
G1_Y = int("08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3E"
           "DD03CC744A2888AE40CAA232946C5E7E1", 16)
FR_GENERATOR = 7
FR_TWO_ADICITY = 32

FR_WORDS, FQ_WORDS = 8, 12
FR_MONT = (1 << 256) % R
FR_MONT_INV = pow(1 << 256, -1, R)
FQ_MONT = (1 << 384) % Q

#: the Jacobian point at infinity
INF = (1, 1, 0)

#: a dot product's row chunk: 16-bit limb products summed over at most
#: this many terms stay below 2^48, and 16 such sums below 2^52, exact in
#: float64
DOT_CHUNK = 1 << 16


def root_of_unity(log_n: int) -> int:
    """The primitive 2^log_n-th root of unity of Fr: 7^((r - 1) / 2^32)
    squared down."""
    if not 0 <= log_n <= FR_TWO_ADICITY:
        raise ValueError(f"no 2^{log_n}-th root of unity in Fr")
    top = pow(FR_GENERATOR, (R - 1) >> FR_TWO_ADICITY, R)
    return pow(top, 1 << (FR_TWO_ADICITY - log_n), R)


def batch_inverse(xs: Sequence[int], mod: int) -> List[int]:
    """1/x for every x (all nonzero) by one inversion and 3 products each."""
    prefix, acc = [], 1
    for x in xs:
        prefix.append(acc)
        acc = acc * x % mod
    inv = pow(acc, -1, mod)
    out = [0] * len(xs)
    for k in range(len(xs) - 1, -1, -1):
        out[k] = prefix[k] * inv % mod
        inv = inv * xs[k] % mod
    return out


def domain(n: int) -> List[int]:
    """The n-point domain [1, w, ..., w^(n-1)] of Fr, n a power of two."""
    w = root_of_unity(n.bit_length() - 1)
    out, acc = [], 1
    for _ in range(n):
        out.append(acc)
        acc = acc * w % R
    return out


def lagrange_at(x: int, n: int, points: Optional[List[int]] = None
                ) -> List[int]:
    """L_j(x) for the n-point domain: (x^n - 1)/n * w^j / (x - w^j)."""
    points = domain(n) if points is None else points
    x %= R
    if x in points:
        return [int(p == x) for p in points]
    c = (pow(x, n, R) - 1) * pow(n, -1, R) % R
    inv = batch_inverse([(x - p) % R for p in points], R)
    return [c * p % R * i % R for p, i in zip(points, inv)]


def powers(x: int, n: int) -> List[int]:
    out, acc = [], 1
    for _ in range(n):
        out.append(acc)
        acc = acc * x % R
    return out


# ---------------------------------------------------------------------------
# Words <-> integers
# ---------------------------------------------------------------------------


def words_to_ints(arr) -> List[int]:
    """(..., L) 32-bit words (any int dtype, little-endian) -> integers."""
    a = np.ascontiguousarray(np.asarray(arr).astype(np.int64) & 0xFFFFFFFF
                             ).astype("<u4")
    n = a.shape[-1] * 4
    raw = a.reshape(-1, a.shape[-1]).tobytes()
    return [int.from_bytes(raw[k:k + n], "little")
            for k in range(0, len(raw), n)]


def ints_to_words(xs: Sequence[int], n_words: int) -> np.ndarray:
    """Integers -> (N, n_words) int32 words, little-endian."""
    raw = b"".join(int(x).to_bytes(4 * n_words, "little") for x in xs)
    return np.frombuffer(raw, dtype="<i4").reshape(len(xs), n_words).copy()


def fr_values(words) -> List[int]:
    """Fr elements from their Montgomery words."""
    return [v * FR_MONT_INV % R for v in words_to_ints(words)]


def fr_words(values: Sequence[int]) -> np.ndarray:
    """The Montgomery words of Fr elements."""
    return ints_to_words([v % R * FR_MONT % R for v in values], FR_WORDS)


# ---------------------------------------------------------------------------
# Exact dot products of rows of Fr words with weight vectors
# ---------------------------------------------------------------------------


def _limbs16(words: torch.Tensor) -> torch.Tensor:
    """(..., L) int32 words -> (..., 2L) float64 16-bit limbs, low first."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], -1).flatten(-2).to(
        torch.float64)


def weight_limbs(weights: Sequence[Sequence[int]], device) -> torch.Tensor:
    """K weight vectors of n integers below 2^256 -> (n, 16 K) float64
    limbs, vector k in columns [16 k, 16 k + 16)."""
    cols = []
    for vec in weights:
        raw = b"".join(int(v).to_bytes(32, "little") for v in vec)
        cols.append(np.frombuffer(raw, dtype="<u2").reshape(len(vec), 16))
    return torch.from_numpy(np.concatenate(cols, 1).astype(np.float64)).to(
        device)


def dot_sums(rows: torch.Tensor, limbs: torch.Tensor,
             block: int = 16) -> torch.Tensor:
    """Exact sums_j words[i, j] * weight_k[j] as limb sums: rows (B, n, 8)
    int32 words, limbs (n, 16 K) from ``weight_limbs`` -> (B, K, 31) int64,
    entry t of which weighs 2^(16 t). Runs on the rows' device, ``block``
    rows at a time."""
    b, n = rows.shape[:2]
    k = limbs.shape[1] // 16
    a_idx = torch.arange(16, device=rows.device)
    diag = (a_idx[:, None] + a_idx[None, :]).flatten()        # (256,)
    out = torch.zeros((b, k, 31), dtype=torch.int64, device=rows.device)
    for lo in range(0, b, block):
        part = rows[lo:lo + block]
        for c in range(0, n, DOT_CHUNK):
            x = _limbs16(part[:, c:c + DOT_CHUNK])             # (b', n', 16)
            s = x.transpose(1, 2) @ limbs[c:c + DOT_CHUNK]     # (b', 16, 16K)
            s = s.view(-1, 16, k, 16).permute(0, 2, 1, 3).reshape(
                -1, k, 256)
            t = torch.zeros(s.shape[:2] + (31,), dtype=torch.float64,
                            device=rows.device)
            t.index_add_(2, diag, s)
            out[lo:lo + block] += t.to(torch.int64)
    return out


def combine(sums) -> List[int]:
    """(..., 31) limb sums -> the integers they stand for, flattened."""
    arr = np.asarray(sums.cpu() if torch.is_tensor(sums) else sums)
    arr = arr.reshape(-1, arr.shape[-1])
    return [sum(int(v) << (16 * t) for t, v in enumerate(row))
            for row in arr]


def row_values(rows: torch.Tensor, limbs: torch.Tensor) -> List[List[int]]:
    """Per row and weight vector the Fr value sum_j e_ij * weight_k[j], with
    e_ij the element whose Montgomery words the rows hold: [row][k]."""
    b = rows.shape[0]
    k = limbs.shape[1] // 16
    flat = [v * FR_MONT_INV % R for v in combine(dot_sums(rows, limbs))]
    return [flat[i * k:(i + 1) * k] for i in range(b)]


# ---------------------------------------------------------------------------
# G1
# ---------------------------------------------------------------------------


def jac_double(p):
    x, y, z = p
    if z == 0 or y == 0:
        return INF
    a = x * x % Q
    b = y * y % Q
    c = b * b % Q
    d = 2 * ((x + b) * (x + b) - a - c) % Q
    e = 3 * a % Q
    x3 = (e * e - 2 * d) % Q
    return x3, (e * (d - x3) - 8 * c) % Q, 2 * y * z % Q


def jac_add_affine(p, a):
    """p (Jacobian) + a (affine (x, y), or None for infinity)."""
    if a is None:
        return p
    x1, y1, z1 = p
    if z1 == 0:
        return a[0], a[1], 1
    zz = z1 * z1 % Q
    u2 = a[0] * zz % Q
    s2 = a[1] * zz % Q * z1 % Q
    h = (u2 - x1) % Q
    rr = (s2 - y1) % Q
    if h == 0:
        return jac_double(p) if rr == 0 else INF
    hh = h * h % Q
    hhh = hh * h % Q
    v = x1 * hh % Q
    x3 = (rr * rr - hhh - 2 * v) % Q
    return x3, (rr * (v - x3) - y1 * hhh) % Q, z1 * h % Q


def to_affine(points):
    """Jacobian points -> affine (x, y), None for infinity, one inversion."""
    zs = [p[2] for p in points if p[2]]
    inv = iter(batch_inverse(zs, Q)) if zs else iter(())
    out = []
    for x, y, z in points:
        if z == 0:
            out.append(None)
            continue
        zi = next(inv)
        zi2 = zi * zi % Q
        out.append((x * zi2 % Q, y * zi2 % Q * zi % Q))
    return out


class Comb:
    """[s] G1 for any s by 32 mixed adds over a table of 8-bit windows:
    entry [w][d] = [d 256^w] G1, affine."""

    def __init__(self):
        self.table = []
        base = (G1_X, G1_Y)
        for _ in range(32):
            row, acc = [None, base], (base[0], base[1], 1)
            jac = []
            for _ in range(2, 257):
                acc = jac_add_affine(acc, base)
                jac.append(acc)
            aff = to_affine(jac)
            self.table.append(row + aff[:-1])        # d = 0 .. 255
            base = aff[-1]                           # 256 * base

    def mul(self, s: int):
        s %= R
        acc = INF
        for w in range(32):
            d = (s >> (8 * w)) & 0xFF
            if d:
                acc = jac_add_affine(acc, self.table[w][d])
        return acc


def point_matches(words, expected) -> bool:
    """Whether the program's point (3, 12) words, homogeneous projective in
    Montgomery form, is the Jacobian point ``expected``."""
    xw, yw, zw = (v % Q for v in words_to_ints(np.asarray(words)))
    x, y, z = expected
    if z == 0:
        return zw == 0 and xw == 0 and yw != 0
    if zw == 0:
        return False
    z2 = z * z % Q
    # x/z^2 = X/Z and y/z^3 = Y/Z; the Montgomery factor of X, Y, Z cancels
    return (xw * z2 - x * zw) % Q == 0 and (yw * z2 % Q * z - y * zw) % Q == 0


def point_words(p) -> np.ndarray:
    """A Jacobian point -> (3, 12) int32 words in the program's format."""
    a = to_affine([p])[0]
    if a is None:
        vals = [0, FQ_MONT, 0]
    else:
        vals = [a[0] * FQ_MONT % Q, a[1] * FQ_MONT % Q, FQ_MONT]
    return ints_to_words(vals, FQ_WORDS)


# ---------------------------------------------------------------------------
# What a round has to give
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Expected:
    """One challenge's outputs as scalars of G1 (and Fr values)."""
    commitments: List[int]   # per row: the scalar of [.] G1
    evals: List[int]         # per row: y_i
    openings: List[int]      # per row: the scalar of [.] G1
    at_z: List[int]          # per row: f_i(z), for the coefficients' check
    aggregate: List[int]     # C, W, C_y, W_y: scalars of [.] G1
    value: int


class Reference:
    """The round's reference for one trapdoor and shape (M workers, rows of
    T). ``z`` is the point at which the program's coefficients are read;
    ``transforms`` the inverse NTTs run before the prove."""

    def __init__(self, tau_x: int, tau_y: int, workers: int, row: int,
                 z: int, device, transforms: Sequence[str] = ("x",)):
        self.tau_x, self.tau_y, self.z = tau_x % R, tau_y % R, z % R
        self.m, self.t = workers, row
        self.device = device
        self.transforms = tuple(transforms)
        self.row_domain = domain(row)
        self.worker_domain = domain(workers)
        self.lag_tau_y = lagrange_at(self.tau_y, workers, self.worker_domain)
        self._fixed = [self._weights(p) for p in (self.tau_x, self.z)]
        self.comb = Comb()

    def _weights(self, x: int) -> List[int]:
        """The weights of a row's words that give g_k(x)."""
        if "x" in self.transforms:
            return lagrange_at(x, self.t, self.row_domain)
        return powers(x % R, self.t)

    def _across(self, g: List[int]) -> List[int]:
        """f_i(x) from every row's g_k(x): the inverse NTT across the
        workers where ``y`` is run, else g itself."""
        if "y" not in self.transforms:
            return g
        m_inv = pow(self.m, -1, R)
        w_inv = pow(self.worker_domain[1], -1, R) if self.m > 1 else 1
        out = []
        for i in range(self.m):
            step, acc, total = pow(w_inv, i, R), 1, 0
            for v in g:
                total += acc * v
                acc = acc * step % R
            out.append(total % R * m_inv % R)
        return out

    def challenge(self, rows: torch.Tensor, alpha: int, beta: int
                  ) -> Expected:
        """rows: the challenge's (M, T, 8) Montgomery words of evaluations;
        alpha, beta: Fr values."""
        alpha, beta = alpha % R, beta % R
        if alpha == self.tau_x or beta == self.tau_y:
            raise ValueError("a challenge point equals the trapdoor")
        limbs = weight_limbs(self._fixed + [self._weights(alpha)],
                             self.device)
        vals = row_values(rows.to(self.device), limbs)
        ftau, at_z, ys = (self._across([v[k] for v in vals])
                          for k in range(3))
        lag = self.lag_tau_y
        den = pow((self.tau_x - alpha) % R, -1, R)
        big_f = sum(l * f for l, f in zip(lag, ftau)) % R
        big_y = sum(l * y for l, y in zip(lag, ys)) % R
        value = sum(l * y for l, y in zip(
            lagrange_at(beta, self.m, self.worker_domain), ys)) % R
        agg = [big_f, (big_f - big_y) * den % R, big_y,
               (big_y - value) * pow((self.tau_y - beta) % R, -1, R) % R]
        return Expected(
            commitments=[l * f % R for l, f in zip(lag, ftau)],
            evals=ys,
            openings=[l * (f - y) % R * den % R
                      for l, f, y in zip(lag, ftau, ys)],
            at_z=at_z, aggregate=agg, value=value)

    # -- the SRS ------------------------------------------------------------

    def srs_scalar(self, kind: str, idx: Sequence[int]) -> int:
        """The scalar of one SRS point: ``g1_x`` (j), ``bases`` (i, j),
        ``lagrange_y`` (i)."""
        idx = [int(v) for v in idx]
        if kind == "g1_x":
            return pow(self.tau_x, idx[0], R)
        if kind == "bases":
            return self.lag_tau_y[idx[0]] * pow(self.tau_x, idx[1], R) % R
        if kind == "lagrange_y":
            return self.lag_tau_y[idx[0]]
        raise ValueError(kind)


def mismatches(points, scalars: Sequence[int], comb: Comb) -> int:
    """How many of the program's points (N, 3, 12) are not [s] G1."""
    return sum(not point_matches(p, comb.mul(s))
               for p, s in zip(np.asarray(points), scalars))
