"""The server's merges, in float64 on the CPU.

``weighted_average``: FedAvg, each model weighted by its sample count
(the sync rounds).  ``staleness_merge``: FedAsync's blend ``w <- (1 -
a_i) w + a_i w_i`` applied update by update in merge order (the async
rounds).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

Params = Dict[str, torch.Tensor]


def weighted_average(models: List[Params], weights: Sequence[float]
                     ) -> Params:
    total = float(sum(weights))
    return {k: sum(float(w) * m[k].double() for m, w in zip(models, weights))
            / total for k in models[0]}


def staleness_merge(start: Params, models: List[Params],
                    alphas: Sequence[float]) -> Params:
    out = {k: t.double() for k, t in start.items()}
    for m, a in zip(models, alphas):
        out = {k: (1.0 - a) * out[k] + a * m[k].double() for k in out}
    return out
