"""The JAX package's framework-free modules, loaded without importing JAX.

``zkp_subnet_tpu/__init__.py`` imports jax, so ``import zkp_subnet_tpu.utils
.oracle`` would pull JAX into every process of the port. The modules below
import only the standard library and numpy, so they are loaded unchanged
(no copy) through synthetic packages whose ``__path__`` points at the JAX
package's directories:

- ``oracle``   — bigint BLS12-381 reference (``utils/oracle.py``);
- ``encoding`` — the wire codec (``utils/encoding.py``);
- ``native``   — ctypes pairing library under ``native/`` (``utils/native.py``);
- ``protocol`` — the ``Prove`` message (``runtime/protocol.py``);
- ``config``   — ``WorkerConfig`` and friends (``runtime/config.py``).
"""

from __future__ import annotations

import importlib
import os
import sys
import types

_REF_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "zkp_subnet_tpu")


def _load(subpackage: str, module: str):
    pkg_name = f"{__name__}._ref_{subpackage}"
    if pkg_name not in sys.modules:
        pkg = types.ModuleType(pkg_name)
        pkg.__path__ = [os.path.join(_REF_ROOT, subpackage)]
        sys.modules[pkg_name] = pkg
    return importlib.import_module(f"{pkg_name}.{module}")


oracle = _load("utils", "oracle")
encoding = _load("utils", "encoding")
native = _load("utils", "native")
protocol = _load("runtime", "protocol")
config = _load("runtime", "config")
