"""Public wrappers around the kernels, and the flat views they work on.

``gqa_flash_attention`` takes the models' layout, q (B,S,H,D) and k/v
(B,T,Hkv,D), to the attention kernel without repeating k/v per group;
``ssm_scan_op`` is the selective scan from a zero state, y only.

``fedagg_pytree`` is the tree-native server aggregation hot path: the
stacked client-update tree is flattened ONCE into a single (N, P) f32
buffer (unflatten spec cached per tree structure), reduced by the fused
fedagg kernel in one pass, and split back — instead of one launch per
leaf.  ``fedagg_fold_pytree`` is its async-window twin over the folded
merge kernel.  ``fedagg_partial_op`` is one client-mesh shard's
unnormalised partial sum (``distributed/aggregate.py``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels.fedagg import fedagg, fedagg_fold, fedagg_partial
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,
                              tree_unflatten)


def gqa_flash_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """q (B,S,H,D); k/v (B,T,Hkv,D) -> (B,S,H,D)."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)


def ssm_scan_op(x, dt, b_in, c_out, a_log):
    """x, dt (B,S,D); b_in, c_out (B,S,N); a_log (D,N) -> y (B,S,D), from
    a zero state.  The model's ``ssm_core`` calls ``ssm_scan`` itself,
    with its carried state."""
    return ssm_scan(x, dt, b_in, c_out, a_log)[0]


def fedagg_op(updates, weights, *, alphas=None):
    return fedagg(updates, weights, alphas=alphas)


# ---------------------------------------------------------------------------
# Tree-native aggregation: flatten once, one kernel pass, cached spec
# ---------------------------------------------------------------------------

# treedef + leaf (shape, dtype) signature -> list of (offset, size, shape,
# dtype) describing how to slice the flat (P,) result back into leaves.
_UNFLATTEN_SPECS: Dict[tuple, List[Tuple[int, int, tuple, object]]] = {}


def _unflatten_spec(treedef, leaves):
    key = (treedef, tuple((tuple(l.shape), str(l.dtype)) for l in leaves))
    spec = _UNFLATTEN_SPECS.get(key)
    if spec is None:
        spec, off = [], 0
        for l in leaves:
            size = int(np.prod(l.shape[1:], dtype=np.int64)) if l.ndim > 1 \
                else 1
            spec.append((off, size, tuple(l.shape[1:]), l.dtype))
            off += size
        _UNFLATTEN_SPECS[key] = spec
    return spec


def flatten_updates(stacked):
    """Stacked tree (leaves (N, ...)) -> ((N, P) f32 buffer, treedef,
    unflatten spec).  The spec is cached per (structure, shapes, dtypes)
    so repeated rounds pay only for the concat itself."""
    leaves, treedef = tree_flatten(stacked)
    if not leaves:
        raise ValueError("empty pytree: nothing to aggregate")
    spec = _unflatten_spec(treedef, leaves)
    n = leaves[0].shape[0]
    buf = torch.cat([l.reshape(n, -1).float() for l in leaves], dim=1)
    return buf, treedef, spec


def unflatten_result(flat, treedef, spec):
    """(P,) flat aggregate -> tree with per-leaf shapes/dtypes restored."""
    outs = [flat[off:off + size].reshape(shape).to(dtype)
            for off, size, shape, dtype in spec]
    return tree_unflatten(treedef, outs)


# Unstacked variant: a single model tree <-> one flat (P,) f32 row.
# Spec format shared with the stacked path: (offset, size, full leaf
# shape, dtype).
_TREE_SPECS: Dict[tuple, tuple] = {}


def tree_spec(tree):
    """-> (treedef, [(offset, size, shape, dtype)], total P) for an
    UNSTACKED tree (no leading client axis).  Cached per structure."""
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        raise ValueError("empty pytree: nothing to flatten")
    key = (treedef, tuple((tuple(l.shape), str(l.dtype)) for l in leaves))
    cached = _TREE_SPECS.get(key)
    if cached is None:
        spec, off = [], 0
        for l in leaves:
            size = int(np.prod(tuple(l.shape), dtype=np.int64))
            spec.append((off, size, tuple(l.shape), l.dtype))
            off += size
        cached = (spec, off)
        _TREE_SPECS[key] = cached
    spec, total = cached
    return treedef, spec, total


def fedagg_pytree(stacked_updates, weights, *, alphas=None):
    """Weighted-average a tree whose leaves are stacked (N, ...).

    Zero-weight rows (masked stragglers) contribute exactly nothing —
    the mask is fused into the kernel, so callers can keep dropped
    clients in the stacked buffer instead of re-packing it.  ``alphas``
    adds per-row staleness coefficients (effective weight
    ``w_c * alpha_c``); a zero-alpha row is masked like a zero weight.
    """
    buf, treedef, spec = flatten_updates(stacked_updates)
    flat = fedagg(buf, weights, alphas=alphas)
    return unflatten_result(flat, treedef, spec)


def flatten_params_row(params):
    """Model tree -> (P,) f32 row in ``flatten_updates`` leaf order (no
    leading client axis) — the global-row companion of the stacked
    (N, P) buffer."""
    return torch.cat([l.reshape(-1).float() for l in tree_leaves(params)])


def fedagg_fold_op(updates, g, coef):
    return fedagg_fold(updates, g, coef)


def fedagg_fold_pytree(global_params, stacked_updates, coef):
    """Folded staleness window merge over trees: ONE kernel pass on the
    flattened (K, P) client-row buffer with the global model as the
    IMPLICIT row 0 (its (P,) row rides in directly — no (K+1, ...)
    concatenated copy).

    This is the SHARED merge program of the async runtime's kernel
    path: the dict-of-trees path and the store-backed window step both
    call it on identically flattened buffers, which is what makes their
    histories bit-identical.  ``coef`` is the (K+1,)
    ``staleness_merge_coefficients`` vector (global first); padded /
    masked rows carry coefficient 0 and contribute exactly nothing.
    """
    buf, treedef, spec = flatten_updates(stacked_updates)
    g_flat = flatten_params_row(global_params)
    flat = fedagg_fold(buf, g_flat, coef)
    out = unflatten_result(flat, treedef, spec)
    return tree_map(lambda g, m: m.to(g.dtype), global_params, out)


def fedagg_partial_op(updates, coef):
    return fedagg_partial(updates, coef)
