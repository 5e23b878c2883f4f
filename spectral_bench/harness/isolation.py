"""What a run may not load: the JAX package of this repository, JAX itself
and Flax.  Names are compared by their top-level module, whole:
`gpuspectral_tpu_torch` begins with `gpuspectral_tpu` and is another
name."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gpuspectral_tpu"})
PORT = "gpuspectral_tpu_torch"


def loaded(forbidden=FORBIDDEN, modules=None) -> list:
    """Sorted names in sys.modules (or `modules`) whose top-level name is
    in `forbidden`."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in forbidden)
