"""The top-level modules that may not be loaded in a process of a run
once its window has closed: JAX, its libraries and the JAX package, whose
name the port's begins with, so names compare whole."""

from __future__ import annotations

import sys
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "zkp_subnet_tpu")


def forbidden_loaded() -> List[str]:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))
