"""Divisibility-aware sharding rules (the JAX package's
``sharding/rules.py``: logical name -> PartitionSpec).

Scheme: 2-D "megatron + FSDP" on a ("data", "model") mesh (the multi-pod
mesh adds a leading "pod" axis used for data parallelism only):

  * column-parallel weights (d_in, d_out): ("data", "model")  -- output dim
    tensor-sharded, input dim FSDP-sharded over the data axis.
  * row-parallel weights (d_out-producing) like wo / w_down: ("model","data").
  * embeddings (V, d): ("model", "data"); lm head (d, V): (None, "model").
  * MoE expert tables (E, d, ff): expert axis on "model" when E divides it
    (arctic 128 % 16 = 0) -- expert parallelism; otherwise experts stay
    local and ff is tensor-sharded (mixtral E=8).
  * norms / biases / gates / conv kernels: replicated.

Every assignment is checked for divisibility against the mesh axis size;
a dim that does not divide falls back to the next candidate or None, so
any (arch x mesh) pair has a placement.  Stacked-layer leading axes
("blocks/") are never sharded.

A rule reads a mesh's ``axis_names`` and ``devices.shape`` and nothing
else (``distributed.mesh.Mesh``, or any stand-in with those two).
Leaves are tensors (``meta`` ones from ``launch.steps.abstract_*``) or
anything with a ``.shape``; paths are the tree's ``/``-joined dict keys
and sequence indices, as the reference's ``_path_str`` gives them.
``named_shardings`` pairs each spec with its mesh: ``shard_shape`` and
the bytes one device holds, which the dry run sums.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np

from repro_torch.tree import tree_map_with_path


class PartitionSpec(tuple):
    """One entry a dimension: an axis name, a tuple of axis names, or
    None (replicated) -- ``jax.sharding.PartitionSpec`` as a tuple.  A
    tuple of one name is that name, as jax normalizes it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))


P = PartitionSpec


class NamedSharding:
    """A spec on a mesh: how a leaf of a given global shape is cut."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def shard_shape(self, global_shape):
        """The shape one device holds; every sharded dim must divide."""
        sizes = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
        out = []
        for i, dim in enumerate(global_shape):
            entry = self.spec[i] if i < len(self.spec) else None
            n = _mesh_size(entry, sizes) if entry is not None else 1
            if dim % n:
                raise ValueError(f"dim {dim} of {tuple(global_shape)} does "
                                 f"not divide over {entry} ({n})")
            out.append(dim // n)
        return tuple(out)

    def device_bytes(self, leaf) -> int:
        """Bytes of ``leaf`` (a tensor) that one device holds."""
        return int(np.prod(self.shard_shape(tuple(leaf.shape)),
                           dtype=np.int64)) * leaf.element_size()


# ordered (regex on path, spec template) -- first match wins.
# templates use axis names; "F" marks the FSDP (data) axis, "M" model.
# A copy of the reference's table (tests pin it to the original).
_RULES = [
    (r"embed$",                ("M", "F")),
    # head (d, V): vocab tensor-sharded ONLY (FSDP on d would put the
    # loss matmul's contraction dim on "data")
    (r"head$",                 (None, "M")),
    (r"moe/router$",           ("F", None)),
    (r"moe/w_(gate|up)$",      ("E", "F", "M")),   # (E, d, ff)
    (r"moe/w_down$",           ("E", "M", "F")),   # (E, ff, d)
    (r"(wq|wk|wv|w_gate|w_up|w_in|w_q|w_k|w_v)$", ("F", "M")),
    (r"(wo|w_down|w_out)$",    ("M", "F")),
    (r"slstm/w$",              ("F", "M")),
    (r"slstm/r$",              (None, "F", "M")),
    (r"w_(dt|bc)$",            ("F", "M")),
    (r"w_if$",                 ("F", None)),
    (r"(ln\d?|.*norm|b|bias|scale\d?|dt_bias|A_log|D|b_if|conv_w)$", None),
]


def _axis_ok(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def _resolve(template, shape, axes: Dict[str, Any], mesh_sizes: Dict[str, int],
             n_lead_none: int) -> PartitionSpec:
    """Fill a spec template, dropping axes that don't divide."""
    spec = [None] * n_lead_none
    used = set()
    if template is None:
        return P(*([None] * (n_lead_none + len(shape))))
    for dim, slot in zip(shape, template):
        if slot is None:
            spec.append(None)
            continue
        name = {"F": axes.get("fsdp"), "M": axes.get("model"),
                "E": axes.get("model")}[slot]
        size = _mesh_size(name, mesh_sizes)
        if name is not None and name not in used and _axis_ok(dim, size):
            spec.append(name)
            used.add(name)
        else:
            spec.append(None)
    return P(*spec)


def _mesh_size(name, mesh_sizes: Dict[str, int]) -> int:
    if name is None:
        return 0
    if isinstance(name, tuple):
        s = 1
        for n in name:
            s *= mesh_sizes.get(n, 1)
        return s
    return mesh_sizes.get(name, 0)


def _path_str(path) -> str:
    return "/".join(path)


def _shape(leaf):
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def param_specs(params, mesh, *, fsdp: bool = True, mode: str = "tp_fsdp"):
    """PartitionSpec tree matching ``params``.

    mode "tp_fsdp" (default): megatron TP on "model" + FSDP on "data".
    mode "fsdp_only": pure ZeRO-3 -- every tensor sharded over the
    combined ("data","model") axes on its first divisible dim; no TP.
    """
    mesh_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    if mode == "fsdp_only":
        return _fsdp_only_specs(params, mesh_sizes)
    axes = {"model": "model" if "model" in mesh_sizes else None,
            "fsdp": "data" if (fsdp and "data" in mesh_sizes) else None}

    def spec_one(path, leaf):
        ps = _path_str(path)
        shape = _shape(leaf)
        in_blocks = "blocks/" in ps or ps.startswith("blocks")
        lead = 1 if in_blocks else 0
        body = shape[lead:]
        for pat, tmpl in _RULES:
            if re.search(pat, ps):
                if tmpl is None:
                    return P(*([None] * len(shape)))
                if len(tmpl) != len(body):
                    break  # fall through to generic
                return _resolve(tmpl, body, axes, mesh_sizes, lead)
        # generic fallback: model on last divisible dim, fsdp on another
        spec = [None] * len(shape)
        msize = _mesh_size(axes["model"], mesh_sizes)
        fsize = _mesh_size(axes["fsdp"], mesh_sizes)
        for i in range(len(shape) - 1, lead - 1, -1):
            if axes["model"] and _axis_ok(shape[i], msize):
                spec[i] = axes["model"]
                break
        for i in range(lead, len(shape)):
            if spec[i] is None and axes["fsdp"] and _axis_ok(shape[i], fsize):
                spec[i] = axes["fsdp"]
                break
        return P(*spec)

    return tree_map_with_path(spec_one, params)


def _fsdp_only_specs(params, mesh_sizes):
    """ZeRO-3: shard the first dim divisible by the full device count
    (falling back to sub-axis groups) over ("data","model")."""
    cand = [a for a in ("data", "model") if a in mesh_sizes]
    full = int(np.prod([mesh_sizes[a] for a in cand]))

    def spec_one(path, leaf):
        shape = _shape(leaf)
        ps = _path_str(path)
        in_blocks = "blocks/" in ps or ps.startswith("blocks")
        lead = 1 if in_blocks else 0
        spec = [None] * len(shape)
        for i in range(lead, len(shape)):
            if shape[i] % full == 0 and full > 1:
                spec[i] = tuple(cand)
                break
        else:
            # fall back to the largest single axis that divides some dim
            for ax in cand:
                done = False
                for i in range(lead, len(shape)):
                    if mesh_sizes[ax] > 1 and shape[i] % mesh_sizes[ax] == 0:
                        spec[i] = ax
                        done = True
                        break
                if done:
                    break
        return P(*spec)

    return tree_map_with_path(spec_one, params)


def batch_specs(batch_shapes, mesh, *, mode: str = "tp_fsdp"):
    """Shard the leading (global-batch) dim over every batch axis that
    divides it; otherwise replicate (long_500k B=1).  In "fsdp_only"
    mode the "model" axis joins the batch axes (pure data parallelism)."""
    mesh_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    names = ("pod", "data", "model") if mode == "fsdp_only" \
        else ("pod", "data")
    baxes = tuple(a for a in names if a in mesh_sizes)
    bsize = int(np.prod([mesh_sizes[a] for a in baxes])) if baxes else 1

    def spec_one(path, leaf):
        shape = _shape(leaf)
        if len(shape) == 0:
            return P()
        if baxes and shape[0] % bsize == 0:
            return P(baxes, *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))

    return tree_map_with_path(spec_one, batch_shapes)


def decode_state_specs(state, mesh):
    """KV/SSM caches: batch dim sharded over data axes when divisible;
    everything else replicated.  Cache layouts: kv k/v (L,B,W,Hkv,Dh),
    pos (L,W); ssm h (L,B,di,n), conv (L,B,K-1,di); xlstm mems."""
    mesh_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    baxes = tuple(a for a in ("pod", "data") if a in mesh_sizes)
    bsize = int(np.prod([mesh_sizes[a] for a in baxes])) if baxes else 1

    def spec_one(path, leaf):
        ps = _path_str(path)
        shape = _shape(leaf)
        if ps.endswith("pos") or len(shape) <= 1:
            return P(*([None] * len(shape)))
        # leaf layouts here are stacked over layers: dim0=L, dim1=batch
        if len(shape) >= 2 and baxes and shape[1] % bsize == 0:
            return P(None, baxes, *([None] * (len(shape) - 2)))
        return P(*([None] * len(shape)))

    return tree_map_with_path(spec_one, state)


def _map_specs(fn, tree):
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    return tree


def named_shardings(spec_tree, mesh):
    """Each PartitionSpec of ``spec_tree`` as a ``NamedSharding`` on
    ``mesh``; structure kept."""
    return _map_specs(lambda s: NamedSharding(mesh, s), spec_tree)
