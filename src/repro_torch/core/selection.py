"""Cross-tier client selection and per-tier timeout thresholds
(paper Alg. 4 "CSTT" + Eqs. 3, 4, 7).

Fidelity note (DESIGN.md §7.1): Eq. 4's written form conflicts with the
text's stated intent; we follow the text and Alg. 4's "select the lowest
tau clients": within each tier, the tau clients with the *fewest*
successful rounds (lowest ct) win, ties broken by a seeded shuffle.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def move_tier(t: int, v_now: float, v_prev: float, n_tiers: int) -> int:
    """Eq. 3: accuracy improved -> faster tier (t-1); regressed -> t+1."""
    if v_now >= v_prev:
        return max(t - 1, 1)
    return min(t + 1, n_tiers)


def select_from_tier(tier_clients: Sequence[int], ct: Dict[int, int],
                     tau: int, rng: np.random.Generator) -> List[int]:
    """Participation-balanced pick: lowest ct first (Eq. 4 intent)."""
    if len(tier_clients) <= tau:
        return list(tier_clients)
    noise = rng.permutation(len(tier_clients))
    scored = sorted(zip(tier_clients, noise),
                    key=lambda cn: (ct.get(cn[0], 0), cn[1]))
    return [c for c, _ in scored[:tau]]


def tier_timeouts(tiers: List[List[int]], at: Dict[int, float], beta: float,
                  omega: float) -> List[float]:
    """Eq. 7: D_max^t = min(mean(at over tier) * beta, Omega)."""
    outs = []
    for members in tiers:
        if members:
            mean_at = float(np.mean([at[c] for c in members]))
            outs.append(min(mean_at * beta, omega))
        else:
            outs.append(omega)
    return outs


def gini(counts: Sequence[float]) -> float:
    """Gini coefficient of a participation-count vector (0 = perfectly
    even, -> 1 = one client takes everything).  Zero-count clients must
    be INCLUDED for the number to mean selection fairness."""
    x = np.sort(np.asarray(list(counts), np.float64))
    n = x.size
    total = float(x.sum())
    if n == 0 or total <= 0:
        return 0.0
    cum = np.cumsum(x)
    return float((n + 1 - 2.0 * float((cum / total).sum())) / n)


def participation_fairness(counts: Dict[int, float],
                           population: int = 0) -> Dict[str, float]:
    """Selection-fairness summary over per-client participation counts.

    ``counts`` maps client -> times selected/merged; clients missing
    from it were never picked.  ``population`` (total client count, 0 =
    unknown) pads the vector with the never-selected clients so Gini
    and coverage describe the whole fleet, not just the winners.
    Returns ``gini``, ``coverage`` (fraction selected at least once),
    ``min``/``max``/``mean`` counts over the padded vector.
    """
    vals = [float(v) for v in counts.values()]
    n = max(int(population), len(vals))
    vec = vals + [0.0] * (n - len(vals))
    if not vec:
        return {"gini": 0.0, "coverage": 0.0, "min": 0.0, "max": 0.0,
                "mean": 0.0, "population": 0}
    nonzero = sum(1 for v in vec if v > 0)
    return {"gini": gini(vec), "coverage": nonzero / n,
            "min": float(min(vec)), "max": float(max(vec)),
            "mean": float(np.mean(vec)), "population": n}


def cstt(t: int, v_prev: float, v_now: float, tiers: List[List[int]],
         at: Dict[int, float], ct: Dict[int, int], tau: int, beta: float,
         omega: float, rng: np.random.Generator
         ) -> Tuple[List[Tuple[int, int]], List[float], int]:
    """Alg. 4.  Returns (selected [(client, tier_idx)], D_max per tier,
    new tier pointer t).  Selects tau clients from EVERY tier 1..t."""
    n_tiers = max(len(tiers), 1)
    t = move_tier(min(t, n_tiers), v_now, v_prev, n_tiers)
    selected: List[Tuple[int, int]] = []
    for k in range(t):                      # tiers 1..t (0-indexed k)
        for c in select_from_tier(tiers[k], ct, tau, rng):
            selected.append((c, k))
    d_max = tier_timeouts(tiers, at, beta, omega)
    return selected, d_max, t
