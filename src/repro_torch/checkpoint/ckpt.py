"""Tree checkpointing to .npz (atomic, step-indexed, pure numpy).

Trees (nested dict / list / tuple, ``repro_torch.tree``) are flattened
in ``jax.tree_util`` order — dict keys sorted — and leaf ``i`` is stored
as ``leaf_{i}``, so a checkpoint written by either package loads in the
other.  Leaves are stored as numpy arrays: a torch tensor is copied to
the host first (the only device read), scalars and ints as 0-d arrays.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_unflatten


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    metadata: Optional[dict] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves, _ = tree_flatten(tree)
    flat = {f"leaf_{i}": _host(l) for i, l in enumerate(leaves)}
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".npz")
    os.close(fd)
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    meta = {"step": step, "n_leaves": len(leaves)}
    if metadata:
        meta.update(metadata)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    return path


def load_checkpoint(ckpt_dir: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like`` (shapes must match).  A
    leaf of ``like`` that is a torch tensor comes back as a tensor on
    its device; any other leaf as a numpy array."""
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        leaves, treedef = tree_flatten(like)
        restored = [data[f"leaf_{i}"] for i in range(len(leaves))]
    for a, b in zip(leaves, restored):
        if tuple(np.shape(a)) != tuple(b.shape):
            raise ValueError(f"shape mismatch: {np.shape(a)} vs {b.shape}")
    return tree_unflatten(treedef, [
        torch.from_numpy(b).to(a.device) if isinstance(a, torch.Tensor)
        else b for a, b in zip(leaves, restored)])


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None
