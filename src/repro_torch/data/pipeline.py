"""Per-client batching pipeline (deterministic, seed-keyed)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass
class ClientDataset:
    x: np.ndarray
    y: np.ndarray

    def __len__(self):
        return len(self.y)


def client_batches(ds: ClientDataset, batch_size: int, epoch_seed: int
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One local epoch of shuffled batches (drops ragged tail like FedLab)."""
    rng = np.random.default_rng(epoch_seed)
    idx = rng.permutation(len(ds))
    n_full = max(len(ds) // batch_size, 1)
    for b in range(n_full):
        sl = idx[b * batch_size:(b + 1) * batch_size]
        if len(sl) == 0:
            break
        yield ds.x[sl], ds.y[sl]


def lm_batches(tokens: np.ndarray, batch: int, seq: int, seed: int
               ) -> Iterator[np.ndarray]:
    rng = np.random.default_rng(seed)
    n = len(tokens) - seq - 1
    while True:
        starts = rng.integers(0, n, batch)
        yield np.stack([tokens[s:s + seq] for s in starts])
