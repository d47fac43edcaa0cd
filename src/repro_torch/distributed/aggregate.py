"""Client-sharded server aggregation: per-shard partial sums + one "psum".

The single-device hot path (``weighted_average_stacked`` /
``fedagg_pytree``) reduces the whole flattened (N, P) update buffer at
once.  Here each shard reduces only its own rows on its own device —
``sum_shard eff_c * u_c`` and ``sum_shard eff_c`` — and the shard
partials are added on ``mesh.devices[0]`` in shard order (the psum of
the reference: one (P,) row and one scalar per shard).

``use_kernel=True`` reduces each shard's rows through the hand-written
``fedagg_partial`` kernel when they lie on a CUDA device; otherwise, and
for CPU tensors, through its plain version.  Both add the rows one at a
time in row order and skip a masked row before reading it, so the zero
rows appended by the plan are a bitwise no-op on both branches (the
reference's jnp branch is ``eff @ masked``, a dot).

Numerics: the reference's masking semantics (rows with ``eff_c = w_c *
alpha_c <= 0`` contribute exactly nothing; an all-masked cohort yields
zeros — or ``fallback`` when given), equal to the single-device
reduction up to float reassociation: partial sums reduce per shard
before they are added, so results match within dtype tolerance, not
bitwise.  ``sharded_staleness_merge`` rides the same reduction with the
staleness coefficients, the global model as an IMPLICIT row 0 (its
coefficient multiplies the flattened global row directly — no (K+1, ...)
concatenated copy).  Nothing here reads a tensor back.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.aggregation import staleness_merge_coefficients
from repro_torch.distributed.plan import ClientShardingPlan
from repro_torch.kernels.fedagg import (_f32_on, fedagg_partial_plain,
                                       ordered_sum)
from repro_torch.kernels.ops import (fedagg_partial_op, flatten_params_row,
                                     flatten_updates, unflatten_result)
from repro_torch.tree import tree_map


def _psum(parts, device):
    """Add per-shard values on ``device`` in shard order."""
    total = parts[0].to(device)
    for part in parts[1:]:
        total = total + part.to(device)
    return total


def _shard_sums(mesh, plan, u, coefs, use_kernel: bool):
    """Per-shard ``sum_r c_r * u_r`` over each shard's slice of the
    padded rows, on that shard's device, then added on the first one.
    ``coefs[s]`` are shard ``s``'s coefficients (the partial sum's
    wrapper moves host ones to the device without blocking)."""
    rows = plan.rows_per_shard
    partial = fedagg_partial_op if use_kernel else fedagg_partial_plain
    parts = []
    for s, dev in enumerate(mesh.devices):
        u_s = u[s * rows:(s + 1) * rows].to(dev)
        parts.append(partial(u_s, coefs[s]))
    return _psum(parts, mesh.devices[0])


def sharded_aggregate(mesh, stacked, weights, *, alphas=None,
                      fallback=None, use_kernel: bool = False):
    """Client-sharded ``weighted_average_stacked``.

    ``stacked`` is a tree whose leaves carry a leading client axis
    (N, ...); ``weights`` (N,) and optional ``alphas`` (N,) multiply
    into per-row effective weights.  The buffer is flattened once into
    (N, P) f32, zero-padded to a multiple of the mesh size with zero
    effective weight (exact no-op rows), reduced per shard — through
    the ``fedagg_partial`` kernel when ``use_kernel`` — and combined on
    the first device.  Returns the aggregated tree with per-leaf
    shapes/dtypes restored.

    ``fallback``: an optional per-row-shaped tree (the global params)
    returned — by a device-side select, no host sync — when every
    effective weight is zero (the all-masked round).
    """
    buf, treedef, spec = flatten_updates(stacked)
    n = buf.shape[0]
    w = _f32_on(weights, buf.device).reshape(-1)
    a = torch.ones_like(w) if alphas is None else _f32_on(
        alphas, buf.device).reshape(-1)
    if w.shape[0] != n or a.shape[0] != n:
        raise ValueError(
            f"weights/alphas length {w.shape[0]}/{a.shape[0]} != rows {n}")
    plan = ClientShardingPlan.for_cohort(n, mesh)
    u = plan.pad_stacked(buf, mode="zero")
    w, a = plan.pad_weights(w), plan.pad_weights(a)
    rows = plan.rows_per_shard
    effs = []
    for s, dev in enumerate(mesh.devices):
        eff = w[s * rows:(s + 1) * rows].to(dev) \
            * a[s * rows:(s + 1) * rows].to(dev)
        effs.append(torch.where(eff > 0.0, eff, torch.zeros_like(eff)))
    num = _shard_sums(mesh, plan, u, effs, use_kernel)
    den = _psum([ordered_sum(e) for e in effs], mesh.devices[0])
    out = unflatten_result(num / torch.clamp(den, min=1e-30), treedef, spec)
    if fallback is None:
        return out
    return tree_map(lambda m, p: torch.where(den > 0.0, m.to(p.dtype), p),
                    out, fallback)


def sharded_staleness_merge(mesh, global_params, stacked, alphas, *,
                            use_kernel: bool = False):
    """Client-sharded ``staleness_weighted_merge``: the async window
    merge as one sharded reduction over the client rows, the global
    model riding as an IMPLICIT row 0 — its coefficient multiplies the
    flattened global row directly instead of concatenating a (K+1, ...)
    copy.  Zero-alpha rows (masked stragglers) contribute exactly
    nothing.  ``use_kernel`` reduces each shard's rows through the
    ``fedagg_partial`` kernel."""
    coef = staleness_merge_coefficients(alphas)
    # normalised on the host (the coefficients are host scalars
    # already), as the reference does
    c = np.where(coef > 0.0, coef, 0.0).astype(np.float64)
    c = (c / max(c.sum(), 1e-30)).astype(np.float32)
    buf, treedef, spec = flatten_updates(stacked)
    plan = ClientShardingPlan.for_cohort(buf.shape[0], mesh)
    cr = plan.pad_weights(c[1:])
    rows = plan.rows_per_shard
    flat_sum = _shard_sums(
        mesh, plan, plan.pad_stacked(buf, mode="zero"),
        [cr[s * rows:(s + 1) * rows] for s in range(mesh.size)],
        use_kernel)
    g = flatten_params_row(global_params).to(flat_sum.device)
    c0 = float(c[0])        # an f32 value: the multiply stays in f32
    g_term = c0 * g if c0 > 0.0 else torch.zeros_like(g)
    merged = unflatten_result(g_term + flat_sum, treedef, spec)
    # unflatten_result restores the STACKED leaves' dtypes; re-cast to
    # the global model's per-leaf dtypes
    return tree_map(lambda gl, m: m.to(gl.dtype), global_params, merged)
