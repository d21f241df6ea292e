"""The modules no process of a run may load: JAX, its libraries and the
JAX package tlab_tpu, compared by whole top-level names (the port's name,
tlab_tpu_torch, begins with the JAX package's)."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "tlab_tpu")


def loaded_forbidden(modules=None) -> list:
    """The names in sys.modules whose top-level name (before the first
    dot) is one of FORBIDDEN, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(n for n in modules if n.split(".", 1)[0] in FORBIDDEN)
