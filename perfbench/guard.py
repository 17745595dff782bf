"""The run's guard against the JAX package and JAX.

The port's package is named after the JAX package with ``_torch`` at the
end, so a name is judged by its top-level part (before the first dot),
whole: ``jpeg_tpu_torch`` passes, ``jpeg_tpu`` and ``jpeg_tpu.api`` do
not.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "jpeg_tpu")


def forbidden(names: Iterable[str]) -> List[str]:
    """The names among ``names`` whose top-level module is forbidden."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def loaded_forbidden() -> List[str]:
    """Forbidden modules this process has loaded."""
    return forbidden(list(sys.modules))
