"""Batched multi-client execution engine — the server's round hot path.

* local training for the whole cohort runs as ONE batched program
  (``trainer.local_train_batch``: a leading client axis over every
  local step) producing a stacked update tree — no per-client host
  round-trips;
* aggregation reduces the stacked tree on device
  (``weighted_average_stacked``), through the tree-native fedagg path
  (single flattened (N, P) kernel pass with fused weight normalization
  + straggler masking) or the per-leaf reduction.

Trainers that cannot batch (no ``local_train_batch``) transparently
take the looped path with identical semantics, so schedulers are
written against the engine only.

``use_kernel_agg=None`` resolves once to "the parameters live on a CUDA
device": on the card the round goes through the hand-written kernel by
default, and an explicit ``False`` selects the per-leaf path.  The
cohort-window methods of the reference (``train_cohort``,
``train_window``, ``merge_staleness``) belong to the async path and
come with it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.aggregation import (aggregate_or_keep,
                                          weighted_average_stacked)
from repro_torch.tree import tree_map, tree_stack


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

    # -- local training -------------------------------------------------
    def _pad_target(self, n: int) -> int:
        return 1 << (n - 1).bit_length()

    def _pad_pow2(self, *lists):
        """Pad parallel per-client lists up to ``_pad_target`` by
        repeating their last element (see ``pad_cohorts``)."""
        if not self.pad_cohorts:
            return lists
        n = len(lists[0])
        target = self._pad_target(n)
        return tuple(l + [l[-1]] * (target - n) for l in lists)

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
                stacked, sizes = self.trainer.local_train_batch(
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

    # -- aggregation ----------------------------------------------------
    def aggregate(self, stacked, weights):
        """Weighted average of the stacked cohort; zero-weight rows are
        masked stragglers and contribute nothing."""
        return weighted_average_stacked(stacked, weights,
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


def make_engine(trainer, *, use_kernel_agg: Optional[bool] = None,
                engine: str = "batched") -> BatchedClientEngine:
    """``engine``: "batched" (default) or "looped" (reference path for
    equivalence tests and A/B benchmarks)."""
    if engine not in ("batched", "looped"):
        raise ValueError(f"unknown engine {engine!r}")
    return BatchedClientEngine(trainer, use_kernel_agg=use_kernel_agg,
                               force_looped=(engine == "looped"))
