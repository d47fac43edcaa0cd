"""Synthetic trainers for runtime tests and server-step benchmarks.

``SyntheticCohortTrainer`` implements the trainer contract —
``init_params`` / ``local_train`` / ``evaluate`` — with a deterministic
elementwise update and no model in the loop, so harnesses can exercise
the scheduler and engine paths and hold whole histories against the
reference's: its arithmetic is elementwise adds, which agree to the
last bit.  The reference's ``local_train_cohort`` serves the async
window path and comes with it.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

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
                 d_seed: float = 0.001, seed_mod: int = 7, device="cpu"):
        self.leaf_specs = dict(leaf_specs or self.DEFAULT_SPECS)
        self.cfg = SimpleNamespace(arch_id=arch_id)
        self.d_client, self.d_seed = float(d_client), float(d_seed)
        self.seed_mod = int(seed_mod)
        self.device = torch.device(device)

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

    def evaluate(self, params) -> float:
        leaves = [l.detach().float().cpu().numpy().ravel()
                  for l in tree_leaves(params)]
        return float(np.tanh(np.abs(np.concatenate(leaves)).mean()))
