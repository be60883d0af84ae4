"""ctypes loader for the native BLS12-381 pairing library (native/).

The port's own copy of ``zkp_subnet_tpu/utils/native.py``; it loads the same
C++ library from ``native/`` at the repository root (found by path: this
file sits at the same depth as the original).

Builds lazily with g++ if the shared object is missing (seconds), mirroring
the reference's build-the-native-prover-on-first-use test flow (reference:
tests/conftest.py:33-49, which cargo-builds fourier). Falls back silently to
the pure-Python oracle when no toolchain is available or
``ZKP_TPU_NO_NATIVE`` is set.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libzkp_native.so")

_lib = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, "libzkp_native.so"],
                       check=True, capture_output=True, timeout=300)
        return os.path.exists(_SO_PATH)
    except Exception:
        return False


def load() -> Optional[ctypes.CDLL]:
    """The native library handle, or None (pure-Python fallback)."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("ZKP_TPU_NO_NATIVE"):
        return None
    if not os.path.exists(_SO_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
        lib.zkp_pairing_product_is_one.restype = ctypes.c_int
        lib.zkp_pairing_product_is_one.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def pairing_product_is_one(pairs) -> Optional[bool]:
    """Native prod e(P_i, Q_i) == 1 over affine int-tuple pairs.

    ``pairs``: [((px, py), ((qx0, qx1), (qy0, qy1))), ...] — canonical
    (non-Montgomery) ints, no points at infinity. None if unavailable.
    The C side returns -1 when a Miller-loop line denominator is zero
    (only reachable for non-r-torsion inputs) — treated as reject here.
    """
    lib = load()
    if lib is None:
        return None
    g1 = b"".join(px.to_bytes(48, "big") + py.to_bytes(48, "big")
                  for (px, py), _ in pairs)
    g2 = b"".join(qx[0].to_bytes(48, "big") + qx[1].to_bytes(48, "big") +
                  qy[0].to_bytes(48, "big") + qy[1].to_bytes(48, "big")
                  for _, (qx, qy) in pairs)
    return lib.zkp_pairing_product_is_one(g1, g2, len(pairs)) == 1


def pairing_check(pairs) -> bool:
    """Production pairing-product check over oracle Jacobian points.

    Dispatches to the C++ library when it builds, else the pure-Python
    oracle. The oracle itself never dispatches here (it is the independent
    reference every implementation is validated against — see
    oracle.pairing_product_is_one), so this is the only fast/slow switch.
    """
    from . import oracle as o
    live = [(o.G1.to_affine(p), o.G2.to_affine(q)) for p, q in pairs
            if not (o.G1.is_infinity(p) or o.G2.is_infinity(q))]
    if not live:
        return True
    result = pairing_product_is_one(live)
    if result is not None:
        return result
    return o.pairing_product_is_one(pairs)
