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

The staleness-merge functions of the reference belong to the async
window path and come with it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

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
