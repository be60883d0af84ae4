"""Canonical serialization matching the reference wire format.

The port's own copy of ``zkp_subnet_tpu/utils/encoding.py``.

Derived from the reference golden vectors (reference: tests/test_miner.py:33-55):
scalars are 32-byte **big-endian** integers, base64-encoded with padding
stripped (43-char strings). Points follow the ZCash BLS12-381 serialization:
G1 compressed = 48 bytes / uncompressed = 96 bytes, with flag bits in the top
three bits of the first byte; the ``--uncompressed`` flag of the reference
prover (reference: utils/config.py:131-136) selects between the two.
"""

from __future__ import annotations

import base64
from typing import List, Optional, Sequence, Tuple

from . import oracle as o

# ---------------------------------------------------------------------------
# Scalars (Fr)
# ---------------------------------------------------------------------------


def b64_encode(raw: bytes) -> str:
    return base64.b64encode(raw).decode("ascii").rstrip("=")


def b64_decode(s: str) -> bytes:
    return base64.b64decode(s + "=" * (-len(s) % 4))


def fr_to_bytes(x: int) -> bytes:
    return (x % o.R).to_bytes(32, "big")


def fr_from_bytes(raw: bytes) -> int:
    x = int.from_bytes(raw, "big")
    if x >= o.R:
        raise ValueError("scalar out of range")
    return x


def fr_to_b64(x: int) -> str:
    return b64_encode(fr_to_bytes(x))


def fr_from_b64(s: str) -> int:
    return fr_from_bytes(b64_decode(s))


def poly_to_b64(coeffs: Sequence[int]) -> List[str]:
    return [fr_to_b64(c) for c in coeffs]


def poly_from_b64(strs: Sequence[str]) -> List[int]:
    return [fr_from_b64(s) for s in strs]


# ---------------------------------------------------------------------------
# Vectorized polynomial codec (numpy byte-twiddling, no per-scalar Python)
#
# The scalar codec above is O(coeffs) interpreter work — minutes at the
# reference mainnet scale 24. These operate directly on
# the (N, 16)-limb device representation: base64 is computed with table
# lookups over the whole batch at once. Wire format is unchanged (43-char
# stripped-padding b64 of 32-byte big-endian scalars).
# ---------------------------------------------------------------------------

import numpy as _np

_B64_CHARS = _np.frombuffer(
    b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/",
    dtype=_np.uint8)
_B64_INV = _np.full(256, 255, dtype=_np.uint8)
_B64_INV[_B64_CHARS] = _np.arange(64, dtype=_np.uint8)
_R_BE = _np.frombuffer(o.R.to_bytes(32, "big"), dtype=_np.uint8)


def limbs_to_b64(limbs) -> List[str]:
    """(N, 16) uint32 little-endian 16-bit *canonical* Fr limbs → 43-char
    b64 strings. Bit-identical to [fr_to_b64(x) for x in ints]."""
    arr = _np.asarray(limbs, dtype=_np.uint32).reshape(-1, 16).astype("<u2")
    be = _np.ascontiguousarray(
        _np.ascontiguousarray(arr).view(_np.uint8).reshape(-1, 32)[:, ::-1])
    n = be.shape[0]
    padded = _np.zeros((n, 33), dtype=_np.uint8)
    padded[:, :32] = be
    g = padded.reshape(n, 11, 3).astype(_np.uint16)
    b0, b1, b2 = g[..., 0], g[..., 1], g[..., 2]
    idx = _np.stack([b0 >> 2,
                     ((b0 & 3) << 4) | (b1 >> 4),
                     ((b1 & 15) << 2) | (b2 >> 6),
                     b2 & 63], axis=-1).astype(_np.uint8)
    raw = _np.ascontiguousarray(
        _B64_CHARS[idx].reshape(n, 44)[:, :43]).tobytes().decode("ascii")
    return [raw[i * 43:(i + 1) * 43] for i in range(n)]


def b64_to_limbs(strs: Sequence[str]) -> "_np.ndarray":
    """43-char b64 scalars → (N, 16) uint32 canonical limbs, with the same
    x < r validation as fr_from_b64. Non-canonical-length inputs fall back
    to the scalar path (whose laxer length semantics are kept for parity).
    Raises ValueError on any invalid scalar."""
    n = len(strs)
    if n == 0:
        return _np.zeros((0, 16), dtype=_np.uint32)
    if any(len(s) != 43 for s in strs):
        ints = poly_from_b64(strs)          # scalar fallback, validates
        raw = b"".join(x.to_bytes(32, "little") for x in ints)
        return _np.frombuffer(raw, dtype="<u2").reshape(
            n, 16).astype(_np.uint32)
    buf = _np.frombuffer("".join(strs).encode("ascii"),
                         dtype=_np.uint8).reshape(n, 43)
    vals = _B64_INV[buf]
    if (vals == 255).any():
        raise ValueError("invalid base64 scalar")
    g = _np.zeros((n, 44), dtype=_np.uint16)
    g[:, :43] = vals
    g = g.reshape(n, 11, 4)
    c0, c1, c2, c3 = g[..., 0], g[..., 1], g[..., 2], g[..., 3]
    by = _np.stack([(c0 << 2) | (c1 >> 4),
                    ((c1 & 15) << 4) | (c2 >> 2),
                    ((c2 & 3) << 6) | c3],
                   axis=-1).astype(_np.uint8).reshape(n, 33)
    be = by[:, :32]
    # range check: every scalar strictly < r (big-endian lexicographic)
    diff = be.astype(_np.int16) - _R_BE.astype(_np.int16)
    nz = diff != 0
    has = nz.any(axis=1)
    first = _np.argmax(nz, axis=1)
    ok = has & (diff[_np.arange(n), first] < 0)
    if not ok.all():
        raise ValueError("scalar out of range")
    le = _np.ascontiguousarray(be[:, ::-1])
    return _np.ascontiguousarray(le).view("<u2").reshape(
        n, 16).astype(_np.uint32)


# ---------------------------------------------------------------------------
# G1 points (ZCash format)
# ---------------------------------------------------------------------------

_COMPRESSED = 1 << 7
_INFINITY = 1 << 6
_Y_SIGN = 1 << 5


def _fq_to_bytes(x: int) -> bytes:
    return x.to_bytes(48, "big")


def _y_is_largest(y: int) -> bool:
    return y > o.Q - y


def g1_to_bytes(p, compressed: bool = True) -> bytes:
    """Serialize a Jacobian G1 point (ZCash rules)."""
    aff = o.G1.to_affine(p)
    if aff is None:
        flags = _INFINITY | (_COMPRESSED if compressed else 0)
        n = 48 if compressed else 96
        out = bytearray(n)
        out[0] = flags
        return bytes(out)
    x, y = aff
    if compressed:
        out = bytearray(_fq_to_bytes(x))
        out[0] |= _COMPRESSED
        if _y_is_largest(y):
            out[0] |= _Y_SIGN
        return bytes(out)
    out = bytearray(_fq_to_bytes(x) + _fq_to_bytes(y))
    return bytes(out)


def g1_from_bytes(raw: bytes):
    """Deserialize to a Jacobian G1 point.

    Validates curve membership AND the r-torsion subgroup check — the G1
    cofactor is ≠ 1, so an on-curve point can sit outside the prime-order
    subgroup; the reference's arkworks deserialization rejects those and a
    scoring path that accepted them would be an adversarial-worker surface
    (reference: neurons/validator.py:77-86 feeds deserialized points
    straight into worker_verify).
    """
    flags = raw[0]
    compressed = bool(flags & _COMPRESSED)
    if compressed != (len(raw) == 48):
        raise ValueError("length/compression mismatch")
    if flags & _INFINITY:
        return o.G1.infinity()
    if compressed:
        x = int.from_bytes(bytes([flags & 0x1F]) + raw[1:], "big")
        if x >= o.Q:
            raise ValueError("x out of range")
        y = o.fq_sqrt((x * x % o.Q * x + o.G1_B) % o.Q)
        if y is None:
            raise ValueError("not on curve")
        if _y_is_largest(y) != bool(flags & _Y_SIGN):
            y = o.Q - y
        p = o.G1.from_affine((x, y))
        if not o.g1_in_subgroup_fast(p):
            raise ValueError("not in r-torsion subgroup")
        return p
    if len(raw) != 96:
        raise ValueError("bad length")
    x = int.from_bytes(bytes([flags & 0x1F]) + raw[1:48], "big")
    y = int.from_bytes(raw[48:], "big")
    if x >= o.Q or y >= o.Q:
        raise ValueError("coordinate out of range")
    p = o.G1.from_affine((x, y))
    if not o.G1.on_curve(p):
        raise ValueError("not on curve")
    if not o.g1_in_subgroup_fast(p):
        raise ValueError("not in r-torsion subgroup")
    return p


def g1_to_b64(p, compressed: bool = True) -> str:
    return b64_encode(g1_to_bytes(p, compressed))


def g1_from_b64(s: str):
    return g1_from_bytes(b64_decode(s))


# ---------------------------------------------------------------------------
# G2 points (ZCash format: c1 limb serialized before c0)
# ---------------------------------------------------------------------------


def g2_to_bytes(p, compressed: bool = True) -> bytes:
    aff = o.G2.to_affine(p)
    if aff is None:
        n = 96 if compressed else 192
        out = bytearray(n)
        out[0] = _INFINITY | (_COMPRESSED if compressed else 0)
        return bytes(out)
    (x0, x1), (y0, y1) = aff
    if compressed:
        out = bytearray(_fq_to_bytes(x1) + _fq_to_bytes(x0))
        out[0] |= _COMPRESSED
        if (y1, y0) > ((o.Q - y1) % o.Q, (o.Q - y0) % o.Q):
            out[0] |= _Y_SIGN
        return bytes(out)
    return bytes(_fq_to_bytes(x1) + _fq_to_bytes(x0) +
                 _fq_to_bytes(y1) + _fq_to_bytes(y0))


def g2_from_bytes(raw: bytes):
    flags = raw[0]
    compressed = bool(flags & _COMPRESSED)
    if compressed != (len(raw) == 96):
        raise ValueError("length/compression mismatch")
    if flags & _INFINITY:
        return o.G2.infinity()
    x1 = int.from_bytes(bytes([flags & 0x1F]) + raw[1:48], "big")
    x0 = int.from_bytes(raw[48:96], "big")
    x = (x0, x1)
    if compressed:
        rhs = o.fq2_add(o.fq2_mul(o.fq2_sqr(x), x), o.G2_B)
        y = _fq2_sqrt(rhs)
        if y is None:
            raise ValueError("not on curve")
        y0, y1 = y
        if ((y1, y0) > ((o.Q - y1) % o.Q, (o.Q - y0) % o.Q)) != bool(flags & _Y_SIGN):
            y = o.fq2_neg(y)
        p = o.G2.from_affine((x, y))
        if not o.G2.in_subgroup(p):
            raise ValueError("not in r-torsion subgroup")
        return p
    y1 = int.from_bytes(raw[96:144], "big")
    y0 = int.from_bytes(raw[144:], "big")
    p = o.G2.from_affine((x, (y0, y1)))
    if not o.G2.on_curve(p):
        raise ValueError("not on curve")
    if not o.G2.in_subgroup(p):
        raise ValueError("not in r-torsion subgroup")
    return p


def _fq2_sqrt(a: o.Fq2) -> Optional[o.Fq2]:
    """Square root in Fq2 via the complex method (q ≡ 3 mod 4)."""
    a0, a1 = a
    if a1 == 0:
        s = o.fq_sqrt(a0)
        if s is not None:
            return (s, 0)
        # sqrt of a non-residue: a0 = -s^2 for some s; sqrt = s*u
        s = o.fq_sqrt((-a0) % o.Q)
        return None if s is None else (0, s)
    # norm = a0^2 + a1^2 must be a QR in Fq
    n = o.fq_sqrt((a0 * a0 + a1 * a1) % o.Q)
    if n is None:
        return None
    inv2 = o.fq_inv(2)
    for sign in (1, -1):
        c0 = (a0 + sign * n) % o.Q * inv2 % o.Q
        x0 = o.fq_sqrt(c0)
        if x0 is None:
            continue
        x1 = a1 * o.fq_inv(2 * x0 % o.Q) % o.Q
        cand = (x0, x1)
        if o.fq2_sqr(cand) == (a0 % o.Q, a1 % o.Q):
            return cand
    return None


def g2_to_b64(p, compressed: bool = True) -> str:
    return b64_encode(g2_to_bytes(p, compressed))


def g2_from_b64(s: str):
    return g2_from_bytes(b64_decode(s))
