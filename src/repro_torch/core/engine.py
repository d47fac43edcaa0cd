"""Batched multi-client execution engine — the server's round hot path.

* local training for the whole cohort runs as ONE batched program
  (``trainer.local_train_batch``: a leading client axis over every
  local step) producing a stacked update tree — no per-client host
  round-trips;
* aggregation reduces the stacked tree on device
  (``weighted_average_stacked``), through the tree-native fedagg path
  (single flattened (N, P) kernel pass with fused weight normalization
  + straggler masking) or the per-leaf reduction.

Trainers that cannot batch (no ``local_train_batch`` /
``local_train_cohort``) transparently take the looped path with
identical semantics, so schedulers are written against the engine only.

``use_kernel_agg=None`` resolves once to "the parameters live on a CUDA
device": on the card the round and the async window merge go through
the hand-written kernels by default, and an explicit ``False`` selects
the per-leaf path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.aggregation import (aggregate_or_keep,
                                          staleness_merge_coefficients,
                                          staleness_weighted_merge,
                                          weighted_average_stacked)
from repro_torch.obs import flstats
from repro_torch.obs import telemetry as obs
from repro_torch.tree import tree_map, tree_stack


def mesh_devices(mesh) -> int:
    """``meta["mesh_devices"]`` of every loop: the client mesh's shard
    count, 1 without a mesh."""
    return int(mesh.size) if mesh is not None else 1


def resolve_kernel_agg(use_kernel_agg: Optional[bool], trainer) -> bool:
    """``None`` -> whether the trainer's device is a CUDA device."""
    if use_kernel_agg is not None:
        return bool(use_kernel_agg)
    return torch.device(getattr(trainer, "device", "cpu")).type == "cuda"


class BatchedClientEngine:
    """Executes a cohort of clients and aggregates them without leaving
    device.  One instance per run (it owns no model state)."""

    def __init__(self, trainer, *, use_kernel_agg: Optional[bool] = None,
                 force_looped: bool = False, pad_cohorts: bool = True):
        self.trainer = trainer
        self.use_kernel_agg = resolve_kernel_agg(use_kernel_agg, trainer)
        self.force_looped = force_looped
        # pad cohort size up to a power of two so the batched program
        # sees O(log C) distinct shapes instead of one per cohort size;
        # pad rows are duplicates of the last client and are sliced off
        # again.
        self.pad_cohorts = pad_cohorts
        self._can_batch = (not force_looped
                           and hasattr(trainer, "local_train_batch"))
        self._can_cohort = (not force_looped
                            and hasattr(trainer, "local_train_cohort"))

    # -- local training -------------------------------------------------
    def _pad_target(self, n: int) -> int:
        """Padded cohort size for ``n`` clients (subclass hook: the
        sharded engine also rounds up to a mesh multiple)."""
        return 1 << (n - 1).bit_length()

    def _pad_pow2(self, *lists):
        """Pad parallel per-client lists up to ``_pad_target`` by
        repeating their last element (see ``pad_cohorts``)."""
        if not self.pad_cohorts:
            return lists
        n = len(lists[0])
        target = self._pad_target(n)
        return tuple(l + [l[-1]] * (target - n) for l in lists)

    def _local_train_batch(self, params, ids, rnd_seed):
        """Trainer dispatch hook (the sharded engine injects its
        ``wrap`` here)."""
        return self.trainer.local_train_batch(params, ids, rnd_seed)

    def _local_train_cohort(self, stacked_starts, ids, seeds):
        return self.trainer.local_train_cohort(stacked_starts, ids, seeds)

    def train_clients(self, params, client_ids: Sequence[int],
                      rnd_seed: int):
        """-> (stacked update tree with leading axis len(client_ids),
        sizes (len(client_ids),) f32).  Empty cohort -> (None, empty)."""
        ids = [int(c) for c in client_ids]
        if not ids:
            return None, np.zeros((0,), np.float32)
        if self._can_batch:
            n = len(ids)
            (run_ids,) = self._pad_pow2(ids)
            try:
                stacked, sizes = self._local_train_batch(
                    params, run_ids, rnd_seed)
                if len(run_ids) != n:
                    stacked = tree_map(lambda l: l[:n], stacked)
                    sizes = sizes[:n]
                return stacked, sizes
            except NotImplementedError:
                self._can_batch = False
        outs = [self.trainer.local_train(params, c, rnd_seed=rnd_seed)
                for c in ids]
        stacked = tree_stack([p for p, _ in outs])
        sizes = np.asarray([s for _, s in outs], np.float32)
        return stacked, sizes

    def train_cohort(self, start_params: Sequence, client_ids: Sequence[int],
                     rnd_seeds: Sequence[int]):
        """Async-window cohort: client i trains from its OWN snapshot
        ``start_params[i]`` with its own data-stream seed.

        -> (stacked update tree with leading axis len(client_ids),
        sizes (len(client_ids),) f32).  Empty cohort -> (None, empty).
        Falls back to looping ``local_train`` per client when the
        trainer lacks ``local_train_cohort``.
        """
        ids = [int(c) for c in client_ids]
        seeds = [int(s) for s in rnd_seeds]
        starts = list(start_params)
        if not ids:
            return None, np.zeros((0,), np.float32)
        if self._can_cohort:
            n = len(ids)
            run_ids, run_seeds, run_starts = self._pad_pow2(ids, seeds,
                                                            starts)
            try:
                stacked, sizes = self._local_train_cohort(
                    tree_stack(run_starts), run_ids, run_seeds)
                if len(run_ids) != n:
                    stacked = tree_map(lambda l: l[:n], stacked)
                    sizes = sizes[:n]
                return stacked, sizes
            except NotImplementedError:
                self._can_cohort = False
        outs = [self.trainer.local_train(p0, c, rnd_seed=s)
                for p0, c, s in zip(starts, ids, seeds)]
        stacked = tree_stack([p for p, _ in outs])
        sizes = np.asarray([s for _, s in outs], np.float32)
        return stacked, sizes

    # -- aggregation ----------------------------------------------------
    def aggregate(self, stacked, weights):
        """Weighted average of the stacked cohort; zero-weight rows are
        masked stragglers and contribute nothing."""
        return weighted_average_stacked(stacked, weights,
                                        use_kernel=self.use_kernel_agg)

    def merge_staleness(self, params, stacked, alphas):
        """Fused staleness-weighted window merge (async runtime): the
        batched equivalent of folding ``staleness_merge`` over the
        stacked rows, one device reduction."""
        return staleness_weighted_merge(params, stacked, alphas,
                                        use_kernel=self.use_kernel_agg)

    def aggregate_or_keep(self, params, stacked, weights):
        """``aggregate`` with the all-masked guard on device: a select
        keeps ``params`` when every effective weight is zero, so the
        round never syncs a weight sum to the host."""
        return aggregate_or_keep(params, stacked, weights,
                                 use_kernel=self.use_kernel_agg)

    # -- fused round ----------------------------------------------------
    def train_round(self, params, client_ids: Sequence[int], rnd_seed: int,
                    weights: Optional[Sequence[float]] = None):
        """Train the cohort and aggregate the survivors.

        ``weights`` defaults to per-client sample counts; pass an
        explicit vector (zeros for masked clients) to drop updates
        without re-packing.  An empty cohort (all-straggler round)
        returns ``params`` unchanged — the FedDCT Alg. 2 convention —
        decided host-side BEFORE training; the all-masked (every
        survivor zero-weighted) guard lives on device.
        """
        tel = obs.TEL
        with tel.span("round.train", cohort=len(client_ids)):
            stacked, sizes = self.train_clients(params, client_ids,
                                                rnd_seed)
        if stacked is None:
            return params
        w = sizes if weights is None else np.asarray(  # fedlint: disable=FED002 -- weights is a host Sequence[float] from the caller, packing not a device readback
            weights, np.float32)
        with tel.span("round.aggregate", cohort=len(client_ids)):
            return self.aggregate_or_keep(params, stacked, w)

    # -- store-backed async window ---------------------------------------
    def train_window(self, store, params, client_ids: Sequence[int],
                     rnd_seeds: Sequence[int], alphas: Sequence[float]):
        """One drained async window against a ``ClientStateStore``:
        gather cohort snapshots -> cohort train -> folded staleness
        merge (zero-coefficient straggler/pad masking) -> scatter the
        new global row back into the merged clients' rows.

        Padded rows ride through the merge with coefficient 0 instead of
        being sliced off, so there is no host repack; the merge is the
        one the dict path runs (the folded fedagg kernel when the engine
        was built with ``use_kernel_agg``), and a zero-coefficient row
        changes none of its bits.  Returns ``(new_params,
        new_global_flat)``.  Nothing here reads a tensor back.
        """
        ids = [int(c) for c in client_ids]
        seeds = [int(s) for s in rnd_seeds]
        n = len(ids)
        if n == 0:
            return params, store.flatten(params)
        tel = obs.TEL
        coef = staleness_merge_coefficients(alphas)
        # residency hook (duck-typed; a dense store has none): a tiered
        # store stages the whole window's rows at once
        stage = getattr(store, "ensure_window", None)
        if stage is not None:
            with tel.span("window.stage", cohort=n):
                stage(ids)
        if self._can_cohort:
            run_ids, run_seeds = self._pad_pow2(ids, seeds)
            with tel.span("window.gather", rows=len(run_ids)):
                starts = store.gather(run_ids)
            try:
                with tel.span("window.train", cohort=n,
                              padded=len(run_ids)):
                    stacked, _ = self._local_train_cohort(starts, run_ids,
                                                          run_seeds)
                flstats.record_update_norm(stacked, n)
                pad = np.zeros(len(run_ids) - n, np.float32)
                with tel.span("window.merge_scatter", rows=len(run_ids)):
                    return store.merge_scatter(
                        run_ids, stacked, np.concatenate([coef, pad]),
                        params, use_kernel=self.use_kernel_agg)
            except NotImplementedError:
                self._can_cohort = False
        # looped fallback (trainers without local_train_cohort): rows
        # still merge + scatter through the store
        with tel.span("window.train", cohort=n, looped=True):
            outs = [self.trainer.local_train(store.gather_one(c), c,
                                             rnd_seed=s)
                    for c, s in zip(ids, seeds)]
        run_ids, trees = self._pad_pow2(ids, [p for p, _ in outs])
        pad = np.zeros(len(run_ids) - n, np.float32)
        with tel.span("window.merge_scatter", rows=len(run_ids)):
            return store.merge_scatter(run_ids, tree_stack(trees),
                                       np.concatenate([coef, pad]), params,
                                       use_kernel=self.use_kernel_agg)


def make_engine(trainer, *, use_kernel_agg: Optional[bool] = None,
                engine: str = "batched", mesh=None) -> BatchedClientEngine:
    """``engine``: "batched" (default) or "looped" (reference path for
    equivalence tests and A/B benchmarks).

    ``mesh``: a 1-D client mesh (``repro_torch.distributed.
    make_client_mesh``) to split cohorts over.  ``None`` or a 1-shard
    mesh selects the plain engine — with one shard the distributed path
    IS this engine, so histories stay bit-identical by construction; a
    mesh of several shards returns the ``ShardedClientEngine``.
    """
    if engine not in ("batched", "looped"):
        raise ValueError(f"unknown engine {engine!r}")
    if mesh is not None and int(mesh.size) > 1:
        if engine == "looped":
            raise ValueError("the looped reference engine cannot shard; "
                             "use engine='batched' with a client mesh")
        from repro_torch.distributed.engine import ShardedClientEngine
        return ShardedClientEngine(trainer, mesh,
                                   use_kernel_agg=use_kernel_agg)
    return BatchedClientEngine(trainer, use_kernel_agg=use_kernel_agg,
                               force_looped=(engine == "looped"))
