"""Pairwise-mask secure aggregation (Bonawitz et al. style, simplified),
the JAX package's ``core/secure_agg.py``.

The paper argues synchronous schemes like FedDCT stay compatible with
existing FL privacy protection while asynchronous FL does not (§1, §2).
Each pair of surviving clients (i, j) derives a shared PRG mask m_ij
from their pair seed; client i uploads w_i + sum_{j>i} m_ij -
sum_{j<i} m_ji.  Masks cancel in the server's sum, so the server learns
only the aggregate, and the survivor set is the one FedDCT's per-tier
timeouts freeze (Eq. 5/6).

The masks are drawn from a ``torch.Generator``, not JAX's PRNG, so they
are not the reference's numbers; they cancel the same way.  The server's
plain sum is the client mesh's partial-sum kernel
(``kernels/fedagg.py: fedagg_partial``) with unit coefficients: it adds
the rows one at a time in row order, ``0 + x0 + x1 + ...``, the order
of the reference's ``sum(xs)``.  A CUDA upload launches the kernel or
raises; on the CPU its plain twin (``fedagg_partial_plain``) takes the
sum.  Nothing in the round calls this module, as in the reference.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels.fedagg import fedagg_partial
from repro_torch.kernels.ops import (flatten_params_row, tree_spec,
                                     unflatten_result)
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


def _pair_seed(base_seed: int, rnd: int, i: int, j: int) -> int:
    a, b = (i, j) if i < j else (j, i)
    return (base_seed * 1_000_003 + rnd * 8_191 + a * 131_071 + b) % (2 ** 31)


def _mask_like(params, seed: int, scale: float = 1.0):
    """Deterministic PRG mask with the same tree structure: one
    generator on the parameters' device, seeded with ``seed``, draws
    each leaf's standard normals (f32) in ``tree_leaves`` order."""
    leaves, treedef = tree_flatten(params)
    dev = leaves[0].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    masks = [torch.randn(tuple(l.shape), generator=gen, dtype=torch.float32,
                         device=dev) * scale for l in leaves]
    return tree_unflatten(treedef, masks)


def mask_update(params, client: int, survivors: Sequence[int], rnd: int,
                weight: float, base_seed: int = 0, scale: float = 1.0):
    """Client-side: w_i*s_i + sum of signed pairwise masks.

    Uploads are PRE-weighted (w_i * s_i) so the server's plain sum over
    masked uploads equals sum(s_i * w_i); the server divides by sum(s).
    """
    out = tree_map(lambda p: p.float() * weight, params)
    for other in survivors:
        if other == client:
            continue
        m = _mask_like(params, _pair_seed(base_seed, rnd, client, other),
                       scale)
        if client < other:
            out = tree_map(lambda a, b: a + b, out, m)
        else:
            out = tree_map(lambda a, b: a - b, out, m)
    return out


def secure_aggregate(masked_updates: Sequence, sizes: Sequence[float]):
    """Server-side: plain sum of masked uploads / sum of sizes.

    Each upload is flattened to one f32 row and the (K, P) rows are
    summed by ``fedagg_partial`` with unit coefficients; the sum of
    ``sizes`` is taken on the host.  The server never sees an unmasked
    individual update.
    """
    treedef, spec, _ = tree_spec(masked_updates[0])
    rows = torch.stack([flatten_params_row(u) for u in masked_updates])
    ones = torch.ones((rows.shape[0],), dtype=torch.float32)
    total = fedagg_partial(rows, ones)
    denom = float(np.sum(sizes))
    return unflatten_result(total / max(denom, 1e-30), treedef, spec)
