"""FedDCT's schedulers replayed from the traffic's delays.

``feddct`` is Alg. 2 with Algs. 3-4: every round the available clients
are tiered by running-average time (tiers of ``n // M``, fastest
first), the tier pointer moves by the accuracy change (Eq. 3), the
``tau`` least-used clients of each tier 1..t are selected (ties broken
by a seeded shuffle), each tier's timeout is ``min(beta * mean time,
Omega)`` (Eq. 7), a client whose delay reaches its tier's timeout is a
straggler that re-enters after a ``kappa``-round re-evaluation, and the
round lasts the longest capped time of a used tier (Eqs. 5-6).
``feddct_async`` keeps selection and turns each round's timeouts into
an aggregation deadline: every completion that lands by it is merged,
with staleness weights ``alpha * (s + 1)^-a``, and late ones are merged
in the round they land in.

The accuracy that moves the tier pointer is the one the run reported
for each round (the reference checks a sample of those values itself).
Each round's record says which clients train, with which data seed and
from which round's global model, and what the run must report.
"""

from __future__ import annotations

import heapq
from typing import Dict, List

import numpy as np


def _evaluate_client(net, client: int, rnd: int, kappa: int,
                     omega: float):
    k = max(kappa, 1)
    times = net.delays([client] * k, rnd, attempt=np.arange(k) + 1)
    return float(np.mean(times)), float(np.minimum(times, omega).sum())


def _tiers(avail: Dict[int, float], m: int) -> List[List[int]]:
    order = sorted(avail, key=lambda c: (avail[c], c))
    return [order[i:i + m] for i in range(0, len(order), m)]


def _select(t: int, acc_prev: float, acc_now: float, tiers, at, ct,
            tau: int, beta: float, omega: float, rng):
    n_tiers = max(len(tiers), 1)
    t = min(t, n_tiers)
    t = max(t - 1, 1) if acc_now >= acc_prev else min(t + 1, n_tiers)
    chosen = []
    for k in range(t):
        members = tiers[k]
        if len(members) <= tau:
            picks = list(members)
        else:
            noise = rng.permutation(len(members))
            ranked = sorted(zip(members, noise),
                            key=lambda cn: (ct.get(cn[0], 0), cn[1]))
            picks = [c for c, _ in ranked[:tau]]
        chosen += [(c, k) for c in picks]
    timeouts = [min(float(np.mean([at[c] for c in members])) * beta, omega)
                if members else omega for members in tiers]
    return chosen, timeouts, t


def feddct(net, tr: Dict, seed: int, accuracy: List[float]) -> List[Dict]:
    """Sync FedDCT over ``len(accuracy)`` rounds.  Round r's record:
    ``train`` [(client, data seed, round of the start model)], ``tier``,
    ``selected``, ``stragglers``, ``time`` (the virtual clock after r)."""
    n, omega, kappa = tr["clients"], tr["omega"], tr["kappa"]
    rng = np.random.default_rng(seed + 7)
    at, ct, spent = {}, {}, []
    for c in range(n):
        at[c], s = _evaluate_client(net, c, 0, kappa, omega)
        ct[c] = 0
        spent.append(s)
    clock = max(spent)
    lane: Dict[int, tuple] = {}
    t, acc_now, acc_prev = 1, 0.0, 0.0
    m = max(n // tr["tiers"], 1)
    out = []
    for rnd, acc in enumerate(accuracy, start=1):
        for c in [c for c, (back, _) in lane.items() if back <= clock]:
            at[c] = lane.pop(c)[1]
        avail = {c: v for c, v in at.items() if c not in lane}
        tiers = _tiers(avail, m)
        chosen, timeouts, t = _select(t, acc_prev, acc_now, tiers, avail, ct,
                                      tr["tau"], tr["beta"], omega, rng)
        delays = net.delays([c for c, _ in chosen], rnd)
        capped: Dict[int, List[float]] = {}
        survivors, stragglers = [], 0
        for (c, k), st in zip(chosen, delays):
            capped.setdefault(k, []).append(min(st, timeouts[k]))
            if st >= timeouts[k]:
                stragglers += 1
                new_at, s = _evaluate_client(net, c, rnd, kappa, omega)
                lane[c] = (clock + s, new_at)
                continue
            survivors.append(c)
            at[c] = (at[c] * ct[c] + st) / (ct[c] + 1)
            ct[c] += 1
        d_round = 0.0
        for k, ts in capped.items():
            d_round = max(d_round, min(max(ts), timeouts[k], omega))
        clock += d_round
        out.append({"train": [(c, rnd, rnd - 1) for c in survivors],
                    "tier": t, "selected": len(chosen),
                    "stragglers": stragglers, "time": clock,
                    "alphas": None})
        acc_prev, acc_now = acc_now, acc
    return out


def feddct_async(net, tr: Dict, seed: int, accuracy: List[float]
                 ) -> List[Dict]:
    """Semi-async FedDCT over ``len(accuracy)`` rounds.  Round r's record
    as ``feddct``'s, ``train`` in merge order (finish time, then client
    id), with each merged update's staleness weight in ``alphas`` and
    ``stragglers`` the completions still in flight after r."""
    n, omega, kappa = tr["clients"], tr["omega"], tr["kappa"]
    alpha, a_exp = tr["async_alpha"], tr["async_a"]
    rng = np.random.default_rng(seed + 19)
    at, ct, spent = {}, {}, []
    for c in range(n):
        at[c], s = _evaluate_client(net, c, 0, kappa, omega)
        ct[c] = 0
        spent.append(s)
    clock = max(spent)
    heap: List[tuple] = []           # (finish, client, version, round, cost)
    inflight = set()
    version, t, acc_now, acc_prev = 0, 1, 0.0, 0.0
    m = max(n // tr["tiers"], 1)
    out = []
    for rnd, acc in enumerate(accuracy, start=1):
        avail = {c: v for c, v in at.items() if c not in inflight}
        deadline = clock + omega
        n_sel = 0
        if avail:
            tiers = _tiers(avail, m)
            chosen, timeouts, t = _select(t, acc_prev, acc_now, tiers, avail,
                                          ct, tr["tau"], tr["beta"], omega,
                                          rng)
            delays = net.delays([c for c, _ in chosen], rnd)
            used = {k for _, k in chosen}
            if used:
                deadline = clock + max(min(timeouts[k], omega) for k in used)
            for (c, _), st in zip(chosen, delays):
                heapq.heappush(heap, (clock + float(st), c, version, rnd,
                                      float(st)))
                inflight.add(c)
            n_sel = len(chosen)
        batch = []
        while heap and heap[0][0] <= deadline:
            batch.append(heapq.heappop(heap))
        alphas = [alpha * (version + i - e[2] + 1.0) ** (-a_exp)
                  for i, e in enumerate(batch)]
        version += len(batch)
        for _, c, _, _, cost in batch:
            at[c] = (at[c] * ct[c] + cost) / (ct[c] + 1)
            ct[c] += 1
            inflight.discard(c)
        clock = deadline if heap else (batch[-1][0] if batch else deadline)
        out.append({"train": [(c, r * 977 + c, r - 1)
                              for _, c, _, r, _ in batch],
                    "tier": t, "selected": n_sel, "stragglers": len(heap),
                    "time": clock, "alphas": alphas})
        acc_prev, acc_now = acc_now, acc
    return out


def client_batches(n: int, batch: int, epochs: int, seed: int
                   ) -> List[np.ndarray]:
    """Sample indices of one client's local steps under data seed
    ``seed``: each epoch a fresh permutation (generator seeded with
    ``seed * 131 + epoch``) cut into full batches, the ragged tail
    dropped."""
    out = []
    for ep in range(epochs):
        idx = np.random.default_rng(seed * 131 + ep).permutation(n)
        for b in range(max(n // batch, 1)):
            out.append(idx[b * batch:(b + 1) * batch])
    return out
