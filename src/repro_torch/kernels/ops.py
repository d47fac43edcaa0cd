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

``quantize_rows`` / ``dequantize_rows`` / ``dequantize_segment`` are the
client-state store's int8 row views (``quant_bits=8``).  They are plain
PyTorch, op for op the reference's, not kernels: the reference writes
them in jnp, not Pallas.
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


def gqa_flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                        softcap=0.0):
    """q (B,S,H,D); k/v (B,T,Hkv,D) -> (B,S,H,D)."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset, softcap=softcap)


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


# ---------------------------------------------------------------------------
# Quantized row views: shifted-scale int8 segments with fused scales
# ---------------------------------------------------------------------------

# int8 grid radius and range divisor.  253 steps (not 254) leave half a
# step of slack on each side of the value range, so snapping the
# zero-point onto the quantization grid can never push a rounded index
# past +/-127 — the round-trip error bound |x - dq(q(x))| <= scale/2
# holds without the clip ever truncating an in-range value.
QUANT_QMAX = 127.0
QUANT_STEPS = 253.0
# 1/253 as the f32 the reference multiplies by, held in a Python float
# (exactly that f32 value): f32 * f32 is exact in f64, so the product
# rounds to the same f32 whichever precision the scalar op runs in
_INV_STEPS = float(np.float32(1.0 / QUANT_STEPS))


def quantize_rows(frows, segs):
    """f32 rows -> (int8 rows, per-segment scale/snap meta).

    ``frows`` is (..., Pf) f32; ``segs`` a tuple of ``(offset, size)``
    float-segment views covering the row (the store's per-leaf layout).
    Returns ``(qrows (..., Pf) int8, meta (..., 2L) f32)`` with
    ``meta[..., j]`` = scale and ``meta[..., L+j]`` = the snap index of
    segment ``j`` (the zero-point in grid steps, ``zp = scale * snap``).

    Per (row, segment): ``scale = range * f32(1/253)`` (a reciprocal
    multiply, as the reference spells it), ``snap = round((lo + hi) /
    (2 * scale))`` and ``q = clip(round((x - zp) / scale), ±127)``, true
    divisions both.  ``torch.round`` rounds half to even, as XLA's and
    numpy's do.  Constant segments (range 0) take scale 1 and snap =
    the value: an exact round trip.  Every op is its own eager kernel,
    so no product is contracted into an FMA with the add or subtract
    that follows it (``zp`` is materialised before ``x - zp``): the
    bits equal the numpy oracle ``ref.quantize_rows_ref`` exactly.
    """
    qs, scales, snaps = [], [], []
    for off, size in segs:
        x = frows[..., off:off + size]
        lo, hi = x.amin(dim=-1), x.amax(dim=-1)
        rng = hi - lo
        flat0 = rng <= 0.0
        scale = torch.where(flat0, 1.0, rng * _INV_STEPS)
        snap = torch.where(flat0, lo, torch.round((lo + hi) / (2.0 * scale)))
        zp = scale * snap
        q = torch.clamp(torch.round((x - zp[..., None]) / scale[..., None]),
                        -QUANT_QMAX, QUANT_QMAX).to(torch.int8)
        qs.append(q)
        scales.append(scale)
        snaps.append(snap)
    return torch.cat(qs, dim=-1), torch.stack(scales + snaps, dim=-1)


def dequantize_rows(qrows, meta, segs):
    """Inverse row view of ``quantize_rows``: (..., Pf) int8 rows plus
    (..., 2L) scale/snap meta -> (..., Pf) f32 rows, ``(q + snap) *
    scale`` per segment.  The add and the multiply are two eager
    kernels, so nothing can contract them into an FMA."""
    return torch.cat([dequantize_segment(qrows, meta, segs, j)
                      for j in range(len(segs))], dim=-1)


def dequantize_segment(qrows, meta, segs, j):
    """One segment's dequantized f32 view (``segs[j]`` of ``qrows``) —
    the per-leaf form the store's gather reshapes straight into leaf
    shapes, skipping the full-row concat."""
    off, size = segs[j]
    q = qrows[..., off:off + size].float()
    return (q + meta[..., len(segs) + j, None]) * meta[..., j, None]


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
