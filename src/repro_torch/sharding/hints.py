"""Activation sharding hints, without a mesh.

The JAX package's model code calls ``hint(x, "batch", None, "model",
None)`` at layer boundaries; with no mesh set the hint is the identity
and every axis has size 1.  The port has no LM mesh yet, so that is all
these do: the model code keeps its calls, and ``axis_size("model") == 1``
means ``attention(context_parallel="auto")`` never picks the
context-parallel branch.
"""

from __future__ import annotations


def axis_size(name: str) -> int:
    """Size of a mesh axis: 1, there being no mesh."""
    return 1


def hint(x, *axes):
    """The identity (no mesh to constrain ``x`` to)."""
    return x
