"""The modules a run may not hold: JAX and the JAX package, compared by
whole top-level name (the port's own name begins with the JAX package's)."""

from __future__ import annotations

import sys
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "torchsnapshot_tpu")


def forbidden_modules() -> List[str]:
    """The forbidden top-level names this process has loaded."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
