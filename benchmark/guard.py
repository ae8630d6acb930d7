"""The modules no benchmark run may load: the JAX package this program was
ported from, its golden model, and JAX itself.  Compared by each loaded
module's whole top-level name (the part before the first dot), since the
program's own name, fsgm_tpu_torch, begins with fsgm_tpu."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "fsgm_tpu", "golden")


def top_level_names(modules=None) -> set[str]:
    return {name.split(".")[0] for name in (sys.modules if modules is None
                                            else modules)}


def forbidden_loaded(modules=None, forbidden=FORBIDDEN) -> list[str]:
    """The forbidden top-level names among the loaded modules, sorted."""
    return sorted(top_level_names(modules) & set(forbidden))
