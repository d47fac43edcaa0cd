"""Dynamic tiering (paper Alg. 3 + Eqs. 1-2).

``tiering`` re-runs every round on the *current* running-average training
times — this is what makes FedDCT's tiers dynamic, vs TiFL's frozen
profiling-time tiers.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def tiering(at: Dict[int, float], m: int) -> List[List[int]]:
    """Alg. 3: sort clients by average time ascending, split into tiers of
    width ``m`` (tier 1 fastest).  Returns list of tiers (client-id lists).

    ``at`` holds only *currently tierable* clients (stragglers under
    re-evaluation are absent, exactly like Alg. 2's flow).
    """
    if not at:
        return []
    order = sorted(at, key=lambda c: (at[c], c))
    m = max(int(m), 1)
    return [order[i:i + m] for i in range(0, len(order), m)]


def assignment(tiers: List[List[int]]) -> Dict[int, int]:
    """client -> 1-indexed tier number for one ``tiering`` output."""
    return {c: k + 1 for k, members in enumerate(tiers) for c in members}


class TierMigrationTracker:
    """Round-indexed tier-migration accounting for DYNAMIC tiering.

    Feed it every round's ``tiering`` output; it diffs each client's
    tier against the last round the client was tierable and counts the
    moves.  Clients absent from a round (in flight, or in the straggler
    re-evaluation lane) keep their last known tier, so a client that
    returns to the same tier is NOT a migration — only genuine
    reassignments count, which is exactly the "how often did tiers
    migrate" datum TiFL-style evaluations tabulate.
    """

    def __init__(self):
        self.prev: Dict[int, int] = {}            # client -> last tier
        self.matrix: Dict[Tuple[int, int], int] = {}
        self.rounds = 0

    def update(self, tiers: List[List[int]]) -> Dict[Tuple[int, int], int]:
        """Record one round's assignment; -> this round's migrations
        ``{(from_tier, to_tier): count}`` (new clients are not moves)."""
        cur = assignment(tiers)
        moves: Dict[Tuple[int, int], int] = {}
        for c, t_new in cur.items():
            t_old = self.prev.get(c)
            if t_old is not None and t_old != t_new:
                moves[(t_old, t_new)] = moves.get((t_old, t_new), 0) + 1
        for key, n in moves.items():
            self.matrix[key] = self.matrix.get(key, 0) + n
        self.prev.update(cur)
        self.rounds += 1
        return moves

    def n_migrations(self) -> int:
        return sum(self.matrix.values())


def update_avg_time(at: float, ct: int, t_train: float) -> float:
    """Eq. 2: running average over successful rounds."""
    return (at * ct + t_train) / (ct + 1)


def evaluate_client(network, client: int, rnd: int, kappa: int,
                    omega: float) -> tuple[float, float]:
    """Profile a client with kappa evaluation rounds (Alg. 2 init and the
    straggler re-evaluation lane).  Attempts are capped at omega each (a
    dead client costs at most kappa*omega and simply re-enters the lane).

    Returns (new_average_time, wall_time_spent).
    """
    k = max(kappa, 1)
    times = network.delays([client] * k, rnd, attempt=np.arange(k) + 1)
    return float(np.mean(times)), float(np.minimum(times, omega).sum())
