"""BLS12-381 prime fields (Fr, Fq) on torch tensors.

Device representation: ``(..., L)`` ``torch.int32`` tensors holding L
little-endian 32-bit limbs bit for bit (Fr: L = 8, Fq: L = 12), Montgomery
form with R = 2^(32·L). That is the same R as the JAX package's 16-bit limbs
(``zkp_subnet_tpu/ops/field.py``: R = 2^(16·2L)), so a Montgomery value
repacks between the two layouts (``lo | hi << 16``) with no change of domain:
``to_limbs16``/``from_limbs16`` are the boundary.

The TPU engines ``ops/lane8.py`` (f32 byte limbs) and ``ops/lazy8.py`` (lazy
signed 49-digit encoding) have no counterpart here: they exist to suit the
TPU vector unit. Their math lives in the fully reduced u32 CIOS Montgomery of
``csrc/mont.cuh`` (``fq.cuh``, ``fr.cuh``) and, for the CPU, in the plain
versions below, which widen to int64 tensors of 16-bit limbs: limb products
stay below 2^32 and column sums below 2^38 (this torch has no uint32
arithmetic on the CPU).

Dispatch: ``mont_mul``, ``add`` and ``sub`` launch kernel K3 (``csrc/fr.cu``,
Fr) or K4 (``csrc/fq.cu``, Fq) on a CUDA tensor and run the plain versions
(``fr_mul_plain``, ``fq_mul_plain``, ...) on a CPU tensor. ``neg``, ``sqr``,
``pow_static``, ``inv``, ``to_mont``, ``from_mont`` and ``powers`` are glue
over those three. Inside a point add the Fq arithmetic stays in registers
(``csrc/g1.cu``).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import kernels

MASK16 = 0xFFFF

__all__ = ["PrimeField", "FR", "FQ", "fr_mul", "fr_add",
           "fr_mul_plain", "fr_add_plain", "fr_sub_plain", "fq_mul_plain",
           "fq_add_plain", "fq_sub_plain"]


# -- 16-bit int64 internals of the plain versions ----------------------------

def _int_to_limbs16(x: int, n: int) -> List[int]:
    return [(x >> (16 * k)) & MASK16 for k in range(n)]


def widen(x: torch.Tensor) -> torch.Tensor:
    """(..., L) int32 32-bit limbs → (..., 2L) int64 16-bit limbs."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([v & MASK16, v >> 16], dim=-1).flatten(-2)


def narrow(v: torch.Tensor) -> torch.Tensor:
    """(..., 2L) int64 16-bit limbs (each < 2^16) → (..., L) int32."""
    v = v.unflatten(-1, (-1, 2))
    w = v[..., 0] | (v[..., 1] << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _carry(t: torch.Tensor, loose: bool = False) -> torch.Tensor:
    """Propagate carries (signed) through the limbs; the top limb keeps the
    overflow (or the sign). Strict: every other limb ends in [0, 2^16).
    ``loose`` (for non-negative t): stop once every limb is ≤ 2^16, which
    skips the long ripple of a carry through limbs of 0xFFFF."""
    while True:
        c = t[..., :-1] >> 16
        done = (t[..., :-1] <= 1 << 16) if loose else (c == 0)
        if bool(done.all()):
            return t
        t = t.clone()
        t[..., :-1] &= MASK16
        t[..., 1:] += c


def _columns(a: torch.Tensor, b: torch.Tensor, width: int) -> torch.Tensor:
    """Column sums Σ_{i+j=k} a_i·b_j of the limb product, k < ``width``.

    The shift of row i by i columns is the skew trick of the JAX package
    (``field.PrimeField._skew_sum``): pad each row to width+1, flatten,
    truncate, reshape, sum."""
    la, lb = a.shape[-1], b.shape[-1]
    assert la + lb - 1 <= width
    prods = a.unsqueeze(-1) * b.unsqueeze(-2)            # (..., la, lb)
    rows = prods.new_zeros(prods.shape[:-1] + (width + 1,))
    rows[..., :lb] = prods
    flat = rows.flatten(-2)[..., :la * width]
    return flat.unflatten(-1, (la, width)).sum(-2)


class PrimeField:
    """Constants and ops of one prime field (see module docstring)."""

    def __init__(self, modulus: int, n_limbs: int, name: str,
                 mul_kernel, add_kernel, sub_kernel):
        self.p = modulus
        self.L = n_limbs                  # 32-bit limbs on the device
        self.L16 = 2 * n_limbs            # 16-bit limbs at the JAX boundary
        self.name = name
        R = 1 << (32 * n_limbs)
        self.mont_r = R % modulus
        self.mont_r2 = R * R % modulus
        self.mont_rinv = pow(R, -1, modulus)
        self._p16 = _int_to_limbs16(modulus, self.L16)
        self._nprime16 = _int_to_limbs16((-pow(modulus, -1, R)) % R, self.L16)
        self._mul_kernel = mul_kernel
        self._add_kernel = add_kernel
        self._sub_kernel = sub_kernel
        self._consts = {}

    # -- host-side conversions ----------------------------------------------

    def ints_to_limbs(self, xs: Sequence[int], device=None) -> torch.Tensor:
        """Host ints (reduced mod p, NOT converted) → (N, L) int32 limbs."""
        nbytes = 4 * self.L
        raw = b"".join((int(x) % self.p).to_bytes(nbytes, "little")
                       for x in xs)
        arr = np.frombuffer(raw, dtype="<i4").reshape(len(xs), self.L)
        return torch.from_numpy(arr.copy()).to(device)

    def limbs_to_ints(self, t: torch.Tensor) -> List[int]:
        """(..., L) int32 limbs → host ints, taken as they are."""
        raw = t.detach().to("cpu", torch.int32).contiguous().numpy()
        raw = raw.astype("<i4").reshape(-1, self.L).tobytes()
        n = 4 * self.L
        return [int.from_bytes(raw[i:i + n], "little")
                for i in range(0, len(raw), n)]

    def encode(self, xs: Sequence[int], device=None) -> torch.Tensor:
        """Host ints → (N, L) Montgomery tensor."""
        return self.ints_to_limbs(
            [int(x) % self.p * self.mont_r % self.p for x in xs], device)

    def decode(self, t: torch.Tensor) -> List[int]:
        """Montgomery tensor → canonical host ints (conversion on the host)."""
        return [v * self.mont_rinv % self.p for v in self.limbs_to_ints(t)]

    def to_limbs16(self, t: torch.Tensor) -> np.ndarray:
        """(..., L) int32 → (..., 2L) uint32 16-bit limbs (the JAX format)."""
        raw = t.detach().to("cpu", torch.int32).contiguous().numpy()
        u16 = raw.astype("<i4").view("<u2")
        return u16.reshape(t.shape[:-1] + (self.L16,)).astype(np.uint32)

    def from_limbs16(self, arr, device=None) -> torch.Tensor:
        """(..., 2L) 16-bit limbs (the JAX format) → (..., L) int32."""
        a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
        if a.shape[-1] != self.L16 or (a >> 16).any():
            raise ValueError(f"{self.name}: expected (..., {self.L16}) "
                             "16-bit limbs")
        i32 = a.astype("<u2").view("<i4").reshape(a.shape[:-1] + (self.L,))
        return torch.from_numpy(i32.copy()).to(device)

    # -- constants ------------------------------------------------------------

    def _const(self, name: str, device) -> torch.Tensor:
        """A constant of the field on ``device``, built once per device."""
        key = (name, str(device))
        if key not in self._consts:
            if name == "p16":
                t = torch.tensor(self._p16, dtype=torch.int64)
            elif name.endswith("_toep"):
                t = self._toeplitz(name)
            else:
                t = self.ints_to_limbs([{"r2": self.mont_r2, "one": 1,
                                         "mont_one": self.mont_r}[name]])[0]
            self._consts[key] = t.to(device)
        return self._consts[key]

    def _toeplitz(self, name: str) -> torch.Tensor:
        """M[i, k] = c[k − i]: ``x @ M`` gives the column sums of the limb
        product x·c (all 2L columns for p; the low L, i.e. mod R, for N')."""
        L = self.L16
        c, width = ((self._p16, 2 * L) if name == "p_toep"
                    else (self._nprime16, L))
        m = torch.zeros((L, width), dtype=torch.float64)
        for i in range(L):
            n = min(L, width - i)
            m[i, i:i + n] = torch.tensor(c[:n], dtype=torch.float64)
        return m

    def zeros(self, shape, device=None) -> torch.Tensor:
        return torch.zeros(tuple(shape) + (self.L,), dtype=torch.int32,
                           device=device)

    def ones(self, shape, device=None) -> torch.Tensor:
        """Montgomery one broadcast to ``shape`` (a contiguous copy)."""
        one = self._const("mont_one", device)
        return one.expand(tuple(shape) + (self.L,)).contiguous()

    # -- plain versions (int64, 16-bit limbs) ---------------------------------

    def _condsub16(self, v: torch.Tensor) -> torch.Tensor:
        """(..., L16+1) normalized value < 2p → (..., L16) value mod p."""
        diff = v - F.pad(self._const("p16", v.device), (0, 1))
        # v ≥ p iff the most significant non-zero limb of v − p is positive
        # (decided before any carry: a negative v − p would borrow through
        # every limb)
        pos = torch.arange(diff.shape[-1], device=v.device)
        top = torch.where(diff != 0, pos, 0).amax(-1, keepdim=True)
        ge = diff.gather(-1, top) >= 0
        return _carry(torch.where(ge, diff, v))[..., :-1]

    def add16(self, a, b):
        return self._condsub16(_carry(F.pad(a + b, (0, 1))))

    def sub16(self, a, b):
        p = self._const("p16", a.device)
        return self._condsub16(_carry(F.pad(a - b + p, (0, 1))))

    def mul16(self, a, b):
        """Montgomery product a·b·R⁻¹ mod p, separated form: T = a·b,
        m = T·N' mod R, (T + m·p)/R, one conditional subtract."""
        L = self.L16
        T = _carry(F.pad(_columns(a, b, 2 * L), (0, 1)), loose=True)
        # the constant products as float64 matmuls against Toeplitz
        # matrices: operands ≤ 2^16, so every sum is an integer < 2^38 and
        # exact in a double
        m = (T[..., :L].double() @ self._const("nprime_toep", a.device)).long()
        m = _carry(F.pad(m, (0, 1)), loose=True)[..., :L]       # mod R
        mp = (m.double() @ self._const("p_toep", a.device)).long()
        # T + m·p ≡ 0 mod R: once its limbs are ≤ 2^16 the low half is
        # either 0 or exactly R, so it carries 1 iff any low limb is set
        S = _carry(T + F.pad(mp, (0, 1)), loose=True)
        high = S[..., L:].clone()
        high[..., 0] += (S[..., :L] != 0).any(-1)
        return self._condsub16(_carry(high))

    def mont_mul_plain(self, a, b):
        return narrow(self.mul16(widen(a), widen(b)))

    def add_plain(self, a, b):
        return narrow(self.add16(widen(a), widen(b)))

    def sub_plain(self, a, b):
        return narrow(self.sub16(widen(a), widen(b)))

    # -- public ops: the kernel on a CUDA tensor, plain on the CPU ------------

    @staticmethod
    def _dispatch(kernel, plain, a, b):
        if a.is_cuda or b.is_cuda:
            return kernel(a.contiguous(), b.contiguous())
        return plain(a, b)

    def mont_mul(self, a, b):
        return self._dispatch(self._mul_kernel, self.mont_mul_plain, a, b)

    def add(self, a, b):
        return self._dispatch(self._add_kernel, self.add_plain, a, b)

    def sub(self, a, b):
        return self._dispatch(self._sub_kernel, self.sub_plain, a, b)

    def neg(self, a):
        """−a: 0 − a, the zero a single broadcast element."""
        return self.sub(self.zeros((), a.device), a)

    def sqr(self, a):
        return self.mont_mul(a, a)

    def pow_static(self, a, e: int):
        """a^e for a Python-int exponent, elementwise: square-and-multiply
        from the least significant bit, as
        ``zkp_subnet_tpu/ops/field.py:324-340`` (which multiplies at every
        bit and selects; skipping the zero bits gives the same values)."""
        out = self.ones(a.shape[:-1], a.device)
        base = a
        for i in range(max(e.bit_length(), 1)):
            if (e >> i) & 1:
                out = self.mont_mul(out, base)
            if e >> (i + 1):
                base = self.sqr(base)
        return out

    def inv(self, a):
        """Batched inversion by Fermat, a^(p−2); 0 ↦ 0."""
        return self.pow_static(a, self.p - 2)

    def to_mont(self, a):
        """Canonical → Montgomery: a·R² ·R⁻¹."""
        return self.mont_mul(a, self._const("r2", a.device))

    def from_mont(self, a):
        """Montgomery → canonical: a·1·R⁻¹."""
        return self.mont_mul(a, self._const("one", a.device))

    def powers(self, x, n: int):
        """[1, x, ..., x^(n-1)] (Montgomery), shape (n, L): log-depth
        doubling of the prefix (``zkp_subnet_tpu/ops/field.py:347-359``)."""
        out = self.ones((1,), x.device)
        cur = x.reshape(1, self.L)                    # x^(len(out))
        while out.shape[0] < n:
            out = torch.cat([out, self.mont_mul(out, cur)])
            cur = self.mont_mul(cur, cur)
        return out[:n]

    @staticmethod
    def select(cond, a, b):
        """cond ? a : b, with cond shaped like the batch dims."""
        return torch.where(cond.unsqueeze(-1), a, b)

    @staticmethod
    def is_zero(a):
        return (a == 0).all(-1)


def fr_mul_plain(a, b):
    """Plain version of K3 ``fr_mul``: Fr Montgomery product, broadcasting."""
    return FR.mont_mul_plain(a, b)


def fr_add_plain(a, b):
    """Plain version of K3 ``fr_add``: Fr addition, broadcasting."""
    return FR.add_plain(a, b)


def fr_sub_plain(a, b):
    """Plain version of K3 ``fr_sub``: Fr subtraction, broadcasting."""
    return FR.sub_plain(a, b)


def fq_mul_plain(a, b):
    """Plain version of K4 ``fq_mul``: Fq Montgomery product, broadcasting."""
    return FQ.mont_mul_plain(a, b)


def fq_add_plain(a, b):
    """Plain version of K4 ``fq_add``: Fq addition, broadcasting."""
    return FQ.add_plain(a, b)


def fq_sub_plain(a, b):
    """Plain version of K4 ``fq_sub``: Fq subtraction, broadcasting."""
    return FQ.sub_plain(a, b)


FR = PrimeField(
    0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    n_limbs=8, name="fr", mul_kernel=kernels.fr_mul,
    add_kernel=kernels.fr_add, sub_kernel=kernels.fr_sub)
FQ = PrimeField(
    0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
    n_limbs=12, name="fq", mul_kernel=kernels.fq_mul,
    add_kernel=kernels.fq_add, sub_kernel=kernels.fq_sub)


def fr_mul(a, b):
    """Fr Montgomery product: K3 on a CUDA tensor, plain on the CPU."""
    return FR.mont_mul(a, b)


def fr_add(a, b):
    """Fr addition: K3 on a CUDA tensor, plain on the CPU."""
    return FR.add(a, b)
