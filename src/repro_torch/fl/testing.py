"""Synthetic trainers for runtime tests and server-step benchmarks.

``SyntheticCohortTrainer`` implements the trainer contract —
``init_params`` / ``local_train`` / ``local_train_cohort`` /
``evaluate`` — with a deterministic elementwise update and no model in
the loop, so harnesses can exercise the scheduler, engine, runtime and
store paths and hold whole histories against the reference's: its
arithmetic is elementwise adds, which agree to the last bit.
``local_train_cohort`` takes the distributed engine's ``wrap=`` hook,
so the client-mesh path runs it sharded.  Like every entry point of the
port it runs on the CUDA device (and raises without one) unless it is
given ``device="cpu"``.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import tree_leaves, tree_map


class SyntheticCohortTrainer:
    """Deterministic multi-leaf trainer: the local "training" step adds
    a per-(client, seed) scalar to every leaf.

    ``leaf_specs`` maps leaf name -> (shape, dtype); the default is a
    small mixed-dtype tree (f32 matrix, bf16 vector, f32 scalar).
    """

    DEFAULT_SPECS: Dict[str, Tuple[tuple, object]] = {
        "w": ((4, 3), torch.float32),
        "b": ((6,), torch.bfloat16),
        "s": ((), torch.float32),
    }

    def __init__(self, leaf_specs: Optional[Dict] = None, *,
                 arch_id: str = "synthetic", d_client: float = 0.01,
                 d_seed: float = 0.001, seed_mod: int = 7, device=None):
        self.leaf_specs = dict(leaf_specs or self.DEFAULT_SPECS)
        self.cfg = SimpleNamespace(arch_id=arch_id)
        self.d_client, self.d_seed = float(d_client), float(d_seed)
        self.seed_mod = int(seed_mod)
        self.device = resolve_device(device)

    @classmethod
    def many_leaf(cls, n_leaves: int = 24, leaf: int = 256,
                  **kw) -> "SyntheticCohortTrainer":
        """Benchmark shape: many uniform f32 leaves, so leaf-by-leaf
        snapshot stacking cost dominates the dict-of-trees arm."""
        specs = {f"l{i:02d}": ((leaf,), torch.float32)
                 for i in range(n_leaves)}
        kw.setdefault("arch_id", "manyleaf")
        kw.setdefault("d_client", 1e-3)
        kw.setdefault("d_seed", 1e-4)
        kw.setdefault("seed_mod", 13)
        return cls(specs, **kw)

    def init_params(self, seed: int = 0):
        rng = np.random.default_rng(seed)
        return {name: torch.from_numpy(
                    np.asarray(rng.normal(size=shape).astype(np.float32))
                ).to(self.device).to(dtype)
                for name, (shape, dtype) in self.leaf_specs.items()}

    def _delta(self, client_id: int, rnd_seed: int) -> float:
        return ((client_id + 1) * self.d_client
                + (rnd_seed % self.seed_mod) * self.d_seed)

    def local_train(self, params, client_id: int, rnd_seed: int):
        d = torch.tensor(self._delta(client_id, rnd_seed),
                         dtype=torch.float32, device=self.device)
        out = tree_map(lambda l: (l.float() + d).to(l.dtype), params)
        return out, 10.0 + client_id

    @staticmethod
    def _cohort_impl(starts, d):
        return tree_map(
            lambda l: (l.float() + d.reshape((-1,) + (1,) * (l.ndim - 1))
                       ).to(l.dtype), starts)

    def local_train_cohort(self, start_params, client_ids, rnd_seeds, *,
                           wrap=None):
        """The ``local_train`` update for a whole cohort at once: client
        i adds its own delta to its own row of ``start_params``.
        ``wrap``: the distributed engine's hook (every arg per-client)."""
        d = torch.from_numpy(np.asarray(
            [self._delta(c, s) for c, s in zip(client_ids, rnd_seeds)],
            np.float32)).to(self.device)
        run = self._cohort_impl if wrap is None else wrap(self._cohort_impl,
                                                          0)
        stacked = run(start_params, d)
        sizes = np.asarray([10.0 + c for c in client_ids], np.float32)
        return stacked, sizes

    def evaluate(self, params) -> float:
        leaves = [l.detach().float().cpu().numpy().ravel()
                  for l in tree_leaves(params)]
        return float(np.tanh(np.abs(np.concatenate(leaves)).mean()))
