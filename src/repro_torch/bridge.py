"""numpy tree <-> torch tree.

The parity tests carry the JAX package's parameters over as numpy
arrays (``jax.device_get``), and ``from_reference`` turns them into the
port's trees.  Leaf order is the sorted-key order of ``tree.py``, the
same as ``jax.tree_util`` and so as the reference's
``kernels/ops.py: flatten_updates``; a MoE block's ``moe`` subtree
(router, expert stacks, and ``dense_mlp`` where the config has a dense
residual) crosses the same way.  bfloat16 numpy arrays (the
``ml_dtypes`` dtype jax hands out) cross as their uint16 bits, so the
round trip is bit-exact.  Like every entry point of the port, the
trees land on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import tree_map


def _leaf_to_torch(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).astype(np.int16)
        t = torch.from_numpy(bits).view(torch.bfloat16)
    else:
        # copy: jax's host arrays are read-only and torch shares memory
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def _leaf_to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.contiguous().view(torch.int16).numpy().view(
            ml_dtypes.bfloat16)
    return t.numpy()


def to_torch(tree_np, device=None):
    """numpy tree -> torch tree on ``device`` (dtypes kept);
    ``resolve_device``: ``cuda`` unless ``"cpu"`` is asked for, and a
    ``RuntimeError`` where there is no CUDA device."""
    device = resolve_device(device)
    return tree_map(lambda a: _leaf_to_torch(a, device), tree_np)


def to_numpy(tree):
    """torch tree -> numpy tree (bfloat16 leaves need ``ml_dtypes``)."""
    return tree_map(_leaf_to_numpy, tree)


def from_reference(params_np, device=None):
    """The JAX package's parameters, as numpy arrays -> the port's, on
    ``device`` as in ``to_torch``."""
    return to_torch(params_np, device)
