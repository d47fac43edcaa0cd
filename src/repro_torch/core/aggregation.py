"""Server-side model aggregation (Alg. 1 line 8 / Alg. 2 last line).

* ``weighted_average_stacked`` — the engine hot path.  Takes a tree
  whose leaves already carry a leading client axis (N, ...) plus a
  weight vector (N,), and reduces on device.  Zero-weight rows are
  masked out (fused straggler masking), so dropped clients never force
  a host-side re-pack of the buffer.  An optional per-row ``alphas``
  vector multiplies the weights; a zero-alpha row is masked exactly
  like a zero weight.  ``use_kernel=True`` routes through the
  tree-native fedagg path (single flattened (N, P) kernel pass);
  otherwise the per-leaf reduction ``_agg``.
* ``aggregate_or_keep`` — ``weighted_average_stacked`` with the
  all-masked guard on device: a ``torch.where`` select returns the
  global params unchanged when every effective weight is zero, so the
  round step never syncs a weight sum back to the host.
* ``weighted_average`` — list-of-trees convenience wrapper kept for the
  looped reference implementations and external callers; it stacks then
  delegates.
* ``staleness_weighted_merge`` — the async runtime's windowed merge:
  the batched equivalent of sequentially applying ``staleness_merge``
  row by row, computed as ONE stacked reduction with the global model
  as an IMPLICIT row 0 (its telescoped coefficient multiplies the
  global leaves directly — no (K+1, ...) copy).

``staleness_merge`` is FedAsync's two-model blend (the one-client
degenerate case of ``staleness_weighted_merge``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels.fedagg import fold_coefficients, fold_rows
from repro_torch.tree import tree_leaves, tree_map, tree_stack


def _as_f32(v, device):
    """Host sequence / numpy array / tensor -> f32 tensor on ``device``
    (an upload or a no-op, never a readback)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(v, np.float32)).to(device)


def _agg(stacked, w, a):
    eff = w * a
    wn = torch.where(eff > 0.0, eff, torch.zeros_like(eff))
    wn = wn / torch.clamp(wn.sum(), min=1e-30)

    def agg(leaf):
        wb = wn.reshape((-1,) + (1,) * (leaf.ndim - 1))
        u = torch.where(wb > 0.0, leaf.float(),
                        torch.zeros((), dtype=torch.float32,
                                    device=leaf.device))
        return torch.sum(u * wb, dim=0).to(leaf.dtype)
    return tree_map(agg, stacked)


def weighted_average_stacked(stacked, weights, *, alphas=None,
                             use_kernel: bool = False):
    """Reduce a stacked update tree (leaves (N, ...)) with weights (N,).

    sum_c eff_c * u_c / sum(eff) with eff_c = w_c * alpha_c
    (``alphas=None`` -> all ones).  Rows with eff_c <= 0 are masked to
    exactly zero before the reduction (straggler masking); if every
    effective weight is zero the result is an all-zeros tree.
    """
    device = tree_leaves(stacked)[0].device
    w = _as_f32(weights, device)
    if use_kernel:
        from repro_torch.kernels import fedagg_pytree
        a = None if alphas is None else _as_f32(alphas, device)
        return fedagg_pytree(stacked, w, alphas=a)
    a = torch.ones_like(w) if alphas is None else _as_f32(alphas, device)
    return _agg(stacked, w, a)


def aggregate_or_keep(params, stacked, weights, *, alphas=None,
                      use_kernel: bool = False):
    """``weighted_average_stacked`` that falls back to ``params`` when
    every effective weight is zero (the all-straggler round), decided
    ON DEVICE by a ``torch.where`` select — no per-round host sync of
    the weight sum.  Leaf shapes/dtypes of ``params`` must match the
    per-row shapes of ``stacked`` (the engine round contract)."""
    device = tree_leaves(stacked)[0].device
    w = _as_f32(weights, device)
    a = None if alphas is None else _as_f32(alphas, device)
    agg = weighted_average_stacked(stacked, w, alphas=a,
                                   use_kernel=use_kernel)
    eff = w if a is None else w * a
    any_live = torch.sum(torch.where(eff > 0.0, eff,
                                     torch.zeros_like(eff))) > 0.0
    return tree_map(lambda p, m: torch.where(any_live, m.to(p.dtype), p),
                    params, agg)


def weighted_average(param_list: Sequence, sizes: Sequence[float],
                     use_kernel: bool = False):
    """FedAvg: sum_c w_c * s_c / sum(s) over a list of update trees."""
    if len(param_list) == 0:
        raise ValueError("no client updates to aggregate")
    return weighted_average_stacked(tree_stack(list(param_list)), sizes,
                                    use_kernel=use_kernel)


def staleness_merge(global_params, client_params, alpha_t: float):
    """FedAsync: w <- (1-a) w + a w_c."""
    return tree_map(
        lambda g, c: ((1 - alpha_t) * g.float()
                      + alpha_t * c.float()).to(g.dtype),
        global_params, client_params)


def staleness_merge_coefficients(alphas) -> np.ndarray:
    """Row coefficients of the fused window merge.

    Sequentially applying ``staleness_merge`` with alphas a_1..a_K
    (row order = merge order) telescopes to the convex combination

        w <- prod_i (1-a_i) * w  +  sum_i a_i * prod_{j>i} (1-a_j) * w_i

    Returns the (K+1,) coefficient vector [global, row_1..row_K]; the
    entries sum to exactly 1 (up to fp), so the normalized stacked
    reduction reproduces the sequential merge in one pass.
    """
    a = np.asarray(alphas, np.float64).reshape(-1)
    one_minus = 1.0 - a
    # suffix[i] = prod_{j>i} (1-a_j); suffix[K-1] = 1
    suffix = np.ones_like(a)
    if a.size > 1:
        suffix[:-1] = np.cumprod(one_minus[::-1])[::-1][1:]
    coef = a * suffix
    g = float(np.prod(one_minus)) if a.size else 1.0
    return np.concatenate([[g], coef]).astype(np.float32)


def _merge_folded(global_params, stacked, coef):
    """Folded window merge: coef (K+1,) row coefficients with the global
    model as the IMPLICIT row 0, leaf by leaf.  Zero-coefficient rows
    are masked to exactly zero BEFORE the multiply, so nonfinite
    garbage in masked rows (and the store's padded rows) contributes
    nothing.  Rows are added one at a time in row order, never by
    ``torch.sum`` over the row axis, whose blocking depends on the row
    count: appended zero-coefficient rows then leave every bit as it
    was, which is what makes the store's padded window equal the dict
    path's unpadded one."""
    c = fold_coefficients(coef, tree_leaves(stacked)[0].device)
    return tree_map(lambda g, leaf: fold_rows(leaf, g, c).to(g.dtype),
                    global_params, stacked)


def staleness_weighted_merge(global_params, stacked, alphas, *,
                             use_kernel: bool = False):
    """Merge a whole aggregation window into the global model at once.

    ``stacked`` holds the window's client models with a leading row axis
    (K, ...); ``alphas`` are the per-row staleness weights
    a_i = alpha * (s_i + 1)^-a in merge order.  The result is the same
    convex combination a sequential ``staleness_merge`` fold would
    produce (up to float reassociation), computed as ONE stacked
    reduction with the global model as an IMPLICIT row 0.  Zero-alpha
    rows (masked stragglers) contribute exactly nothing.

    ``use_kernel=True`` routes through the folded fedagg kernel
    (``fedagg_fold_pytree``): the same formulation on the flattened
    (K, P) buffer.  The store-backed window step dispatches the SAME
    function on the same flattened buffer, so histories are
    bit-identical between the dict and store snapshot paths.
    """
    coef = staleness_merge_coefficients(alphas)
    if use_kernel:
        from repro_torch.kernels import fedagg_fold_pytree
        return fedagg_fold_pytree(global_params, stacked, coef)
    return _merge_folded(global_params, stacked, coef)
