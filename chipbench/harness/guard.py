"""The benchmark measures `repro_torch` alone: no module of JAX or of the
JAX package may be loaded in the process that prints the result.
Modules are compared by their top-level name (before the first dot),
whole, so `repro_torch` is not `repro`."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_loaded(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
