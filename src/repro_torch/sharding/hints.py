"""Activation sharding hints (the JAX package's ``sharding/hints.py``).

Model code calls ``hint(x, "batch", None, "model", None)`` at layer
boundaries.  With a mesh set (``set_mesh``, by the launcher or the dry
run) each axis name resolves as the reference's does -- "batch" expands
to every present data-parallel axis (("pod", "data"), and "model" too
under ``fsdp_only``, where the tensor-parallel "model" hints are
no-ops), an axis that does not divide its dimension is dropped -- and
``axis_size`` reports the mesh's sizes, which pick routes in the model
(context-parallel attention, expert parallelism, the decode head-dim
split).  With no mesh every axis has size 1 and the hint is the
identity.

Under GSPMD a sharding constraint never changes a value, only where it
lives.  A mesh whose devices are one physical device (the virtual
shards of ``--force_client_shards``, or the ``meta`` devices of the
production meshes) has nothing to move, so ``hint`` returns its input
there, after checking its rank; ``hint_spec`` gives the spec it
resolved.  A mesh over more than one physical GPU raises
``NotImplementedError``: placing tensors across GPUs is ROADMAP queue
1 item 15.
"""

from __future__ import annotations

import numpy as np

_MESH = None
_SIZES = {}
_FSDP_ONLY = False


def set_mesh(mesh, fsdp_only: bool = False) -> None:
    """Enable hints for ``mesh`` (or disable with None).

    fsdp_only: pure ZeRO-3 data parallelism -- the "model" axis joins the
    batch axes and all tensor-parallel hints become no-ops."""
    global _MESH, _SIZES, _FSDP_ONLY
    if mesh is not None:
        # a stand-in mesh with no device list (a shape alone) is taken
        physical = {d for d in getattr(mesh.devices, "flat", ())
                    if d.type != "meta"}
        if len(physical) > 1:
            raise NotImplementedError(
                f"a mesh over {len(physical)} devices "
                f"({sorted(map(str, physical))}): the port places tensors "
                "on one physical device only; execution across GPUs is "
                "ROADMAP.md queue 1 item 15")
    _MESH = mesh
    _FSDP_ONLY = fsdp_only
    _SIZES = {} if mesh is None else dict(
        zip(mesh.axis_names, mesh.devices.shape))


def get_mesh():
    return _MESH


def axis_size(name: str) -> int:
    """Size of a mesh axis under the active mesh (1 when disabled)."""
    return _size(_expand(name))


def _expand(name):
    if name == "batch":
        names = ("pod", "data", "model") if _FSDP_ONLY else ("pod", "data")
        axes = tuple(a for a in names if a in _SIZES)
        return axes if axes else None
    if isinstance(name, str):
        if _FSDP_ONLY and name == "model":
            return None                    # TP hints no-op in ZeRO-3 mode
        return name if name in _SIZES else None
    return name


def _size(axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, tuple):
        return int(np.prod([_SIZES.get(a, 1) for a in axes]))
    return _SIZES.get(axes, 1)


def hint_spec(shape, *axes):
    """The spec ``hint`` resolves for a tensor of ``shape``: one entry a
    dimension, an axis name, a tuple of names or None; None when no
    mesh is set or no axis survives (the reference then returns ``x``
    unconstrained).  Raises ``ValueError`` on a rank mismatch."""
    if _MESH is None or not _SIZES:
        return None
    if len(axes) != len(shape):
        raise ValueError(f"hint rank {len(axes)} != tensor rank {len(shape)}")
    spec = []
    for dim, a in zip(shape, axes):
        a = _expand(a)
        s = _size(a)
        spec.append(a if (a is not None and s > 1 and dim % s == 0) else None)
    if all(s is None for s in spec):
        return None
    return tuple(spec)


def hint(x, *axes):
    """Constrain ``x`` (rank must match len(axes)); divisibility-checked.
    Every device of a mesh ``set_mesh`` accepts is one physical device,
    so the constraint moves nothing: ``x`` itself is returned."""
    if _MESH is None or not _SIZES:
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"hint rank {len(axes)} != tensor rank {x.ndim}")
    return x
