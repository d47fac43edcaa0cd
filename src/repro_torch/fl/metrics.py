"""Run history: accuracy / time / tier traces, JSON round-trip."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional

# serialization schema of ``to_json``; bump on breaking layout changes.
# v0 = the pre-versioned ``__dict__`` dump (no ``schema_version`` key),
# still accepted by ``from_json``.
SCHEMA_VERSION = 1


@dataclass
class RunHistory:
    method: str
    arch: str
    times: List[float] = field(default_factory=list)       # virtual seconds
    rounds: List[int] = field(default_factory=list)
    accuracy: List[float] = field(default_factory=list)
    tier: List[int] = field(default_factory=list)
    n_selected: List[int] = field(default_factory=list)
    n_stragglers: List[int] = field(default_factory=list)
    meta: Dict = field(default_factory=dict)

    def record(self, *, time: float, rnd: int, acc: float, tier: int = 0,
               n_selected: int = 0, n_stragglers: int = 0):
        self.times.append(float(time))
        self.rounds.append(int(rnd))
        self.accuracy.append(float(acc))
        self.tier.append(int(tier))
        self.n_selected.append(int(n_selected))
        self.n_stragglers.append(int(n_stragglers))

    def best_accuracy(self, smooth: int = 5) -> float:
        if not self.accuracy:
            return 0.0
        import numpy as np
        a = np.asarray(self.accuracy)
        if len(a) < smooth:
            return float(a.max())
        k = np.convolve(a, np.ones(smooth) / smooth, mode="valid")
        return float(k.max())

    def time_to_accuracy(self, target: float) -> Optional[float]:
        for t, a in zip(self.times, self.accuracy):
            if a >= target:
                return t
        return None

    # -- JSON round-trip -------------------------------------------------
    def to_json(self) -> Dict:
        """Plain-dict form with an explicit top-level ``schema_version``
        (kept OUT of ``meta`` so a load/save cycle leaves ``meta``
        byte-identical to what the run recorded)."""
        d = {"schema_version": SCHEMA_VERSION}
        d.update({f.name: getattr(self, f.name) for f in fields(self)})
        return d

    @classmethod
    def from_json(cls, d: Dict) -> "RunHistory":
        """Inverse of ``to_json``.  Accepts legacy v0 dicts (no
        ``schema_version``); rejects versions newer than this code;
        ignores unknown keys so minor forward drift loads."""
        d = dict(d)
        version = d.pop("schema_version", 0)
        if version > SCHEMA_VERSION:
            raise ValueError(
                f"RunHistory schema_version {version} is newer than "
                f"supported {SCHEMA_VERSION}; upgrade the code")
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f)

    @classmethod
    def load(cls, path: str) -> "RunHistory":
        with open(path) as f:
            return cls.from_json(json.load(f))
