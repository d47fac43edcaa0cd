"""Client-sharded execution engine: cohorts split over a client mesh.

``BatchedClientEngine`` made a cohort ONE batched program over a
leading client axis; this subclass splits that axis over the shards of
a ``ClientMesh`` (``distributed/mesh.py``).  Each shard's snapshots,
data batches and per-client streams move to the shard's device, local
epochs run shard by shard with no traffic between shards (the client
axis is embarrassingly parallel), and the merge reduces per-shard
partial sums on the first device (``repro_torch.distributed.aggregate``,
kernel ``fedagg_partial`` when ``use_kernel_agg``).

Trainers opt in through the ``wrap`` hook of ``local_train_batch`` /
``local_train_cohort``: the trainer hands its stacked-train function
(plus how many leading args are replicated) to the engine, which
returns the sharded runner.  Trainers without the hook — or without the
batched paths at all — keep the inherited single-device semantics, so
every scheduler keeps working unmodified.

With every shard on one device (the forced virtual shards of
``distributed/hostdevices.py``) the shards run one after the other on
that device's stream: the same arithmetic as several devices, no
parallelism.  Runs over more than one physical GPU are unverified.

Single-device note: ``make_engine(..., mesh=<1-shard mesh>)``
deliberately returns the plain ``BatchedClientEngine`` — the
distributed path with one shard IS the existing engine, bit-identical
by construction rather than by tolerance.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, Optional

import torch

from repro_torch.core.engine import BatchedClientEngine
from repro_torch.distributed.aggregate import (sharded_aggregate,
                                               sharded_staleness_merge)
from repro_torch.distributed.plan import ClientShardingPlan
from repro_torch.tree import tree_leaves, tree_map


def shard_cohort_train(mesh, train_fn: Callable, *,
                       replicated: int = 0) -> Callable:
    """Wrap a stacked-train function in a client-sharded runner.

    ``train_fn(*args)`` must treat its leading client axis elementwise
    (the engine contract).  The first ``replicated`` positional args go
    whole to every shard (the shared global params of the sync path);
    every remaining arg is a stacked tree whose leading axis is split
    over the mesh's shards.  Cohorts are padded to a multiple of the
    mesh size by repeating the last real row (deterministic duplicate
    work, sliced off again), so uneven cohorts and cohorts smaller than
    the mesh both work.  Each shard's output comes back to the first
    device, concatenated in shard order.
    """
    def run(*args):
        sharded_args = args[replicated:]
        if not sharded_args:
            raise ValueError("shard_cohort_train needs at least one "
                             "sharded (per-client) argument")
        n = tree_leaves(sharded_args[0])[0].shape[0]
        plan = ClientShardingPlan.for_cohort(n, mesh)
        padded = [plan.pad_stacked(a, mode="edge") for a in sharded_args]
        rows = plan.rows_per_shard
        outs = []
        for s, dev in enumerate(mesh.devices):
            lo, hi = s * rows, (s + 1) * rows
            rep = [tree_map(lambda l: l.to(dev), a)
                   for a in args[:replicated]]
            part = [tree_map(lambda l: l[lo:hi].to(dev), a)
                    for a in padded]
            outs.append(train_fn(*rep, *part))
        first = mesh.devices[0]
        out = tree_map(lambda *ls: torch.cat([l.to(first) for l in ls]),
                       *outs)
        return plan.unpad(out)

    return run


class ShardedClientEngine(BatchedClientEngine):
    """``BatchedClientEngine`` whose cohorts are split over a 1-D client
    mesh and whose merges are sharded reductions.  One instance per
    (run, mesh)."""

    def __init__(self, trainer, mesh, *,
                 use_kernel_agg: Optional[bool] = None,
                 pad_cohorts: bool = True, **kw):
        super().__init__(trainer, use_kernel_agg=use_kernel_agg,
                         pad_cohorts=pad_cohorts, **kw)
        if len(mesh.axis_names) != 1:
            raise ValueError(
                f"client mesh must be 1-D, got axes {mesh.axis_names}")
        self.mesh = mesh
        self._wrapped: Dict[tuple, Callable] = {}
        self._accepts_wrap: Dict[str, bool] = {}

    # -- cohort padding: compose pow2 with the mesh multiple ------------
    def _pad_target(self, n: int) -> int:
        # lists padded here land on a multiple of the mesh size already,
        # so the edge padding inside shard_cohort_train is a no-op
        # whenever the cohort is a single shape bucket.
        return ClientShardingPlan.for_cohort(n, self.mesh,
                                             pow2=True).padded_n

    # -- trainer hook ---------------------------------------------------
    def _wrap(self, train_fn: Callable, replicated: int) -> Callable:
        """The ``wrap`` hook handed to trainers: one sharded runner per
        (function, replicated-arity)."""
        key = (getattr(train_fn, "__func__", train_fn), int(replicated))
        fn = self._wrapped.get(key)
        if fn is None:
            fn = shard_cohort_train(self.mesh, train_fn,
                                    replicated=replicated)
            self._wrapped[key] = fn
        return fn

    def _trainer_takes_wrap(self, name: str) -> bool:
        ok = self._accepts_wrap.get(name)
        if ok is None:
            try:
                params = inspect.signature(
                    getattr(self.trainer, name)).parameters
                ok = "wrap" in params
            except (TypeError, ValueError):
                ok = False
            self._accepts_wrap[name] = ok
        return ok

    def _local_train_batch(self, params, ids, rnd_seed):
        if self._trainer_takes_wrap("local_train_batch"):
            return self.trainer.local_train_batch(params, ids, rnd_seed,
                                                  wrap=self._wrap)
        return super()._local_train_batch(params, ids, rnd_seed)

    def _local_train_cohort(self, stacked_starts, ids, seeds):
        if self._trainer_takes_wrap("local_train_cohort"):
            return self.trainer.local_train_cohort(stacked_starts, ids,
                                                   seeds, wrap=self._wrap)
        return super()._local_train_cohort(stacked_starts, ids, seeds)

    # -- aggregation: per-shard partial sums, added on the first device --
    def aggregate(self, stacked, weights):
        return sharded_aggregate(self.mesh, stacked, weights,
                                 use_kernel=self.use_kernel_agg)

    def aggregate_or_keep(self, params, stacked, weights):
        # the all-masked guard rides the summed denominator: a
        # device-side select, no host sync
        return sharded_aggregate(self.mesh, stacked, weights,
                                 fallback=params,
                                 use_kernel=self.use_kernel_agg)

    def merge_staleness(self, params, stacked, alphas):
        return sharded_staleness_merge(self.mesh, params, stacked, alphas,
                                       use_kernel=self.use_kernel_agg)
