"""Non-iid client partitioners (paper §5.1: primary-class fraction "#"),
the benchmark's frozen copy of ``repro_torch/data/partition.py``."""

from __future__ import annotations

from typing import List

import numpy as np


def iid_partition(labels: np.ndarray, n_clients: int, seed: int = 0
                  ) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(labels))
    return [np.sort(s) for s in np.array_split(idx, n_clients)]


def primary_class_partition(labels: np.ndarray, n_clients: int,
                            primary_frac: float, seed: int = 0
                            ) -> List[np.ndarray]:
    """Paper's scheme: each client gets a random primary class holding
    ``primary_frac`` of its samples; the rest is drawn uniformly from the
    other classes.  primary_frac<=1/n_classes degenerates to iid."""
    n_classes = int(labels.max()) + 1
    if primary_frac <= 1.0 / n_classes:
        return iid_partition(labels, n_clients, seed)
    rng = np.random.default_rng(seed)
    by_class = [rng.permutation(np.where(labels == c)[0]).tolist()
                for c in range(n_classes)]
    per_client = len(labels) // n_clients
    n_primary = int(round(primary_frac * per_client))
    primaries = rng.integers(0, n_classes, n_clients)
    out: List[np.ndarray] = []
    for ci in range(n_clients):
        pc = int(primaries[ci])
        take: List[int] = []
        pool = by_class[pc]
        k = min(n_primary, len(pool))
        take += pool[:k]
        by_class[pc] = pool[k:]
        # fill the remainder from other classes (round-robin by size)
        need = per_client - len(take)
        others = [c for c in range(n_classes) if c != pc]
        while need > 0:
            sizes = np.array([len(by_class[c]) for c in others])
            if sizes.sum() == 0:
                break
            c = others[int(np.argmax(sizes))]
            take.append(by_class[c].pop())
            need -= 1
        out.append(np.array(sorted(take), np.int64))
    return out

