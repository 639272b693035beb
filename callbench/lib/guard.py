"""Modules a run may not hold: JAX and the JAX package. Names are compared
whole, by the part before the first dot, so the port (whose name begins
with the JAX package's) passes."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "clair3_rna_tpu")


def forbidden_modules(modules=None, forbidden=FORBIDDEN):
    """Sorted top-level names in `modules` (default sys.modules) that are
    forbidden."""
    names = modules if modules is not None else list(sys.modules)
    return sorted({m.split(".", 1)[0] for m in names} & set(forbidden))
