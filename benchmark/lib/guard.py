"""The modules a run may not hold: JAX, jaxlib, flax and the JAX package.

Compared by whole top-level name, the part of a module's name before the
first dot: ``eitx_torch`` is the measured package, ``eitx`` the JAX one.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "eitx"})


def forbidden_modules(names=None) -> list:
    """The loaded modules (or ``names``) whose top-level name is
    forbidden, sorted."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def keep_jax_out(environ) -> None:
    """Environment settings that keep libraries the port uses from loading
    JAX on their own (``transformers`` reads ``USE_FLAX``)."""
    environ.setdefault("USE_FLAX", "0")
    environ.setdefault("USE_JAX", "0")
