"""Cohort padding plan for the client mesh axis.

Every shard of the mesh takes the same number of rows, but FL cohorts
are whatever the scheduler drained: N not divisible by the mesh, N
smaller than the mesh, ragged shape buckets.  ``ClientShardingPlan``
owns the arithmetic (the reference's, number for number), reusing the
engine's two padding conventions so padded rows are exact no-ops:

* **training** pads by repeating the last real row (``mode="edge"``,
  the engine's pow2-padding convention): duplicate rows do duplicate,
  deterministic work and are sliced off by ``unpad``;
* **aggregation** pads with zero rows *and* zero weights/alphas
  (``mode="zero"`` + ``pad_weights``): the masked row sums skip any row
  with effective weight <= 0 before reading it, so padded rows
  contribute exactly nothing to the merge.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.distributed.mesh import CLIENT_AXIS
from repro_torch.tree import tree_map


@dataclass(frozen=True)
class ClientShardingPlan:
    """How a cohort of ``n`` client rows lands on a ``mesh_size``-way
    client mesh: padded to ``padded_n`` (a multiple of the mesh size,
    >= the mesh size)."""

    n: int
    mesh_size: int
    padded_n: int
    axis: str = CLIENT_AXIS

    @classmethod
    def for_cohort(cls, n: int, mesh, *,
                   pow2: bool = False) -> "ClientShardingPlan":
        """Plan for ``n`` rows over ``mesh`` (a ``ClientMesh`` or a raw
        size).

        ``pow2=True`` first rounds ``n`` up to the next power of two —
        the engine's convention — then up to a multiple of the mesh
        size.
        """
        if isinstance(mesh, int):
            d, axis = mesh, CLIENT_AXIS
        else:
            d, axis = int(mesh.size), mesh.axis_names[0]
        if n < 1:
            raise ValueError(f"cohort must have at least one row, got {n}")
        if d < 1:
            raise ValueError(f"mesh must have at least one device, got {d}")
        m = int(n)
        if pow2:
            m = 1 << (m - 1).bit_length()
        m = -(-m // d) * d
        return cls(n=int(n), mesh_size=d, padded_n=m, axis=axis)

    @property
    def pad_rows(self) -> int:
        return self.padded_n - self.n

    @property
    def rows_per_shard(self) -> int:
        return self.padded_n // self.mesh_size

    def pad_stacked(self, tree, *, mode: str = "edge"):
        """Pad every leaf's leading (client) axis up to ``padded_n``.

        ``mode="edge"`` repeats the last real row (training path);
        ``mode="zero"`` appends zero rows (aggregation path — pair with
        ``pad_weights`` so the mask makes them exact no-ops).
        """
        if mode not in ("edge", "zero"):
            raise ValueError(f"unknown pad mode {mode!r}")
        if not self.pad_rows:
            return tree

        def pad_leaf(leaf):
            shape = (self.pad_rows,) + tuple(leaf.shape[1:])
            if mode == "edge":
                fill = leaf[-1:].expand(shape)
            else:
                fill = torch.zeros(shape, dtype=leaf.dtype,
                                   device=leaf.device)
            return torch.cat([leaf, fill], dim=0)

        return tree_map(pad_leaf, tree)

    def pad_weights(self, vec):
        """Zero-fill an (N,) weight/alpha vector to ``padded_n`` as f32
        (a tensor stays on its device; host data becomes a CPU tensor):
        a padded row's effective weight is 0, so the merge treats it
        exactly like a masked straggler."""
        if isinstance(vec, torch.Tensor):
            vec = vec.to(torch.float32).reshape(-1)
        else:
            vec = torch.from_numpy(np.asarray(vec, np.float32).reshape(-1))
        if not self.pad_rows:
            return vec
        return torch.cat([vec, torch.zeros(self.pad_rows,
                                           dtype=torch.float32,
                                           device=vec.device)])

    def unpad(self, tree):
        """Slice every leaf back to the real ``n`` rows."""
        if not self.pad_rows:
            return tree
        return tree_map(lambda l: l[: self.n], tree)
