"""The benchmark's run of one cell: inputs, the program, the window.

A cell (``BENCHMARK.json: workloads``) names a configuration
(``configs/<config>.json``: the model's family and widths) and a traffic
mix (``traffic/<traffic>.json``: the method, the population and its
tiers, each client's samples, the FL hyper-parameters, the warm-up and
the sampling of the correctness check).  The configuration's family and
the mix's method name modules (``families/<family>.py``,
``methods/<method>.py``) that hold what differs between them.
Everything here is driven by those files; a new cell is new files and a
new entry.

One run:

1. Set-up.  The inputs are made from ``--seed`` by the frozen copies of
   the program's own generators (``frozen/``): the family's samples and
   their partition over the clients, and the wireless delays.  The
   family's trainer (the program's ``CNNTrainer`` for ``cnn``) is handed
   these clients and test samples; ``run_method`` gets the frozen
   network.
2. Warm-up: every cohort shape the traffic can give, once
   (``warm_shapes``), then the first ``warmup_rounds`` rounds of the
   run.
3. The window: whole rounds that follow, until ``seconds`` have passed
   at the end of a round; the run then stops through the program's own
   early stop (its ``target_accuracy`` test after a round's
   evaluation).  The seconds the check's host copies take (after the
   device has finished the round's work so far) are the harness's, not
   the program's: they are kept apart from the window and the set-up.
4. The check (``check.py``) once the window has closed and the
   program's state is freed.

The harness sees the program only at its trainer's boundary (the calls
that train a cohort and the evaluation that ends every round) and in its
telemetry spans; it records there which clients trained, and copies the
global model of each round into a ring on the device so that a sampled
round's models can be judged afterwards.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from flbench.frozen.network import WirelessNetwork


# -- the manifest and the cell's files ---------------------------------

def load_manifest(root: Path) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve_cell(root: Path, name: str) -> Dict:
    """The cell ``name`` with its configuration, traffic mix and the
    metric files it reports, each found by name under ``root``."""
    man = load_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in man["configs"]}
    entry = configs[cell["config"]]
    cfg = json.loads((root / entry["file"]).read_text())
    tr = json.loads((root / "flbench" / "traffic"
                     / f"{cell['traffic']}.json").read_text())

    def reports(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in man["end_to_end"] if reports(m)]
    layers = [m for m in man["per_layer"] if reports(m)]
    readers = {m["name"]: root / "flbench" / "metrics" / f"{m['name']}.py"
               for m in layers}
    for path in readers.values():
        if not path.is_file():
            raise SystemExit(f"missing metric reader {path}")
    return {"name": name, "chips": cell["chips"], "config": cfg,
            "traffic": tr, "end_to_end": e2e, "per_layer": layers,
            "readers": readers, "run_seconds": man["run_seconds"],
            "method": load_module(root, "methods", tr["method"]),
            "family": load_module(root, "families", cfg["family"])}


_MODULES: Dict[Path, object] = {}


def load_module(root: Path, kind: str, name: str):
    """``flbench/<kind>/<name>.py`` under ``root`` (a federated method
    under ``methods``, a model family under ``families``), loaded once."""
    path = (root / "flbench" / kind / f"{name}.py").resolve()
    if path not in _MODULES:
        if not path.is_file():
            raise SystemExit(f"missing {kind} module {path}")
        spec = importlib.util.spec_from_file_location(
            f"flbench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


# -- inputs ------------------------------------------------------------

def make_inputs(cell: Dict, seed: int) -> Dict:
    """The family's samples, the clients' partition and the network, all
    from ``seed``."""
    cfg, tr = cell["config"], cell["traffic"]
    inputs = cell["family"].make_data(cfg, tr, seed)
    inputs["net"] = WirelessNetwork(
        tr["clients"], tr["tier_delay_means"], tr["delay_std"], tr["mu"],
        tuple(tr["failure_delay"]), seed)
    return inputs


def fl_config(tr: Dict, seed: int):
    from repro_torch.config.base import FLConfig
    return FLConfig(
        n_clients=tr["clients"], n_tiers=tr["tiers"], tau=tr["tau"],
        beta=tr["beta"], kappa=tr["kappa"], omega=tr["omega"],
        rounds=tr["rounds"], local_epochs=tr["local_epochs"],
        batch_size=tr["batch_size"], lr=tr["lr"], optimizer=tr["optimizer"],
        tier_delay_means=tuple(tr["tier_delay_means"]),
        delay_std=tr["delay_std"], mu=tr["mu"],
        failure_delay=tuple(tr["failure_delay"]),
        primary_frac=tr["primary_frac"], seed=seed,
        async_alpha=tr["async_alpha"], async_a=tr["async_a"])


def build_trainer(cell: Dict, inputs: Dict, seed: int, device):
    """The family's trainer for the cell's configuration, holding the
    harness's clients and test samples, and the FL configuration."""
    fl = fl_config(cell["traffic"], seed)
    trainer = cell["family"].build_trainer(cell["config"], fl, inputs, seed,
                                           device)
    return trainer, fl


# -- the program's tree as named leaves ---------------------------------

def named_leaves(tree, prefix: str = "") -> List:
    """[(dotted name, tensor)] of a nested dict / list tree, dict keys
    sorted, list entries in position."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += named_leaves(tree[k], f"{prefix}{k}.")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, t in enumerate(tree):
            out += named_leaves(t, f"{prefix}{i}.")
        return out
    return [(prefix[:-1], tree)]


def host(t: torch.Tensor) -> torch.Tensor:
    """A copy on the host (``.cpu()`` of a CPU tensor would alias it)."""
    return t.detach().to("cpu", copy=True)


def row_of(stacked, i: int) -> torch.Tensor:
    return torch.cat([t[i].detach().reshape(-1).float()
                      for _, t in named_leaves(stacked)])


class _RunConfig:
    """The FL configuration as the program reads it, with the early stop
    in the harness's hand: ``target_accuracy`` is 0 (off) until the
    window closes, then -1, which every accuracy meets."""

    def __init__(self, fl):
        self._fl = fl
        self.target_accuracy = 0.0

    def __getattr__(self, name):
        return getattr(self._fl, name)


# -- the recorder at the trainer's boundary -----------------------------

class Recorder:
    """Hooks on the trainer: what each round trained, the window's clock
    and the copies that the check needs.

    Round r ends when the program evaluates its global model.  Each
    training call of the round is recorded (clients, data seeds, rows
    trained).  The global model of each round is copied into a ring of
    ``check.ring`` device buffers; for the rounds the check samples, the
    global models their updates started from, the round's result and,
    for ``check.rows`` picked rows, Adam's first moment after their
    first local step (the trainer's ``_step_impl``) and their trained
    models are copied to the host (with ``check.all_rows``, every live
    row's trained model, so that the round's merge can be redone from
    the program's own updates).  The warm-up rounds are always sampled;
    in a traced run the window's first ``quiet`` rounds, which the
    profiler records, are not.  The seconds those host copies take are
    counted in ``copy_s``, apart from the run's clock."""

    def __init__(self, trainer, cell: Dict, seed: int, seconds: float,
                 run_cfg: _RunConfig, on_window=None, quiet: int = 0):
        tr = cell["traffic"]
        self.trainer = trainer
        self.tr = tr
        self.method = cell["method"]
        self.check = tr["check"]
        self.warmup = tr["warmup_rounds"]
        self.quiet = quiet
        self.seconds = float(seconds)
        self.run_cfg = run_cfg
        self.on_window = on_window or (lambda event, rnd: None)
        rng = np.random.default_rng([seed, 7_356_001])
        self.offset = int(rng.integers(self.check["every"]))
        self.row_rng = rng
        self.rounds: List[Dict] = []          # finished rounds
        self.calls: List[Dict] = []           # calls of the open round
        self.init: Optional[torch.Tensor] = None
        self.shapes: List = []
        self.ring: Dict[int, torch.Tensor] = {}
        self.captured: Dict[int, Dict] = {}   # round -> host copies
        self.t_start = self.t_end = None
        self.copy_s = {"setup": 0.0, "window": 0.0}
        self.defer = 0
        self._step_rows, self._first = None, None
        self._orig = {k: getattr(trainer, k) for k in
                      ("init_params", "local_train_batch",
                       "local_train_cohort", "evaluate", "_step_impl")}
        trainer.init_params = self._init_params
        trainer.local_train_batch = self._train_batch
        trainer.local_train_cohort = self._train_cohort
        trainer.evaluate = self._evaluate
        trainer._step_impl = self._step

    def release(self):
        """Unhook the trainer and drop every device copy."""
        for k, f in self._orig.items():
            setattr(self.trainer, k, f)
        self.trainer = None
        self.ring = {}

    def _copies(self, make):
        """``make()``, which copies to the host: the device first
        finishes the work queued so far, then the copies' seconds are
        counted in ``copy_s`` (set-up before the window opens)."""
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = make()
        self.copy_s["setup" if self.t_start is None else "window"] += (
            time.perf_counter() - t0)
        return out

    # -- sampling ------------------------------------------------------
    def _round(self) -> int:
        return len(self.rounds) + 1

    def _sampled(self, rnd: int) -> bool:
        if rnd <= self.warmup:
            return True
        k = rnd - self.warmup - 1 - self.quiet - self.offset
        return (k >= 0 and k % self.check["every"] == 0) or self.defer == rnd

    def _starts_held(self, rnd: int, seeds, ids) -> bool:
        """Whether the ring still holds every start model of the round's
        updates."""
        if rnd <= self.warmup:
            return True
        oldest = rnd - len(self.ring)
        return all(self.method.start_round(rnd, s, c) >= oldest
                   for s, c in zip(seeds, ids))

    # -- hooks ----------------------------------------------------------
    def _init_params(self, seed):
        params = self._orig["init_params"](seed)
        self.shapes = [(n, tuple(t.shape)) for n, t in named_leaves(params)]
        size = sum(int(np.prod(s)) for _, s in self.shapes)
        dev = named_leaves(params)[0][1].device
        self.ring = {i: torch.empty(size, device=dev)
                     for i in range(self.check["ring"])}
        self._slot = {}
        kept = self._keep(0, params)
        self.init = self._copies(lambda: host(kept))
        return params

    def _keep(self, rnd: int, params) -> torch.Tensor:
        """Round ``rnd``'s global model into the ring (evicting round
        ``rnd - ring``); returns the copy."""
        slot = rnd % len(self.ring)
        torch.cat([t.detach().reshape(-1).float()
                   for _, t in named_leaves(params)], out=self.ring[slot])
        self._slot[rnd] = slot
        self._slot.pop(rnd - len(self.ring), None)
        return self.ring[slot]

    def _held(self, rnd: int) -> torch.Tensor:
        return self.ring[self._slot[rnd]]

    def _pick(self, ids, seeds):
        """Before a training call: the live rows whose first step and
        trained model the check will judge (none unless the round is
        sampled and the ring holds every start it needs)."""
        rnd = self._round()
        live = len(dict.fromkeys(ids))
        if not self._sampled(rnd):
            return []
        if not self._starts_held(rnd, seeds[:live], ids[:live]):
            self.defer = rnd + 1
            return []
        return sorted(int(i) for i in self.row_rng.choice(
            live, size=min(self.check["rows"], live), replace=False))

    def _train(self, kind, run, ids, seeds):
        picks = self._pick(ids, seeds)
        self._step_rows, self._first = picks, None
        stacked, sizes = run()
        live = len(dict.fromkeys(ids))
        call = {"kind": kind, "ids": [int(c) for c in ids[:live]],
                "seeds": [int(s) for s in seeds[:live]],
                "rows": len(ids), "live": live}
        if picks:
            kept = range(live) if self.check.get("all_rows") else picks
            call["row_copies"] = self._copies(
                lambda: {i: host(row_of(stacked, i)) for i in kept})
            call["picks"] = picks
            call["first_m"] = self._first or {}
        self._step_rows = None
        self.calls.append(call)
        return stacked, sizes

    def _train_batch(self, params, client_ids, rnd_seed, **kw):
        ids = [int(c) for c in client_ids]
        return self._train("batch", lambda: self._orig["local_train_batch"](
            params, client_ids, rnd_seed, **kw), ids, [int(rnd_seed)] * len(ids))

    def _train_cohort(self, start_params, client_ids, rnd_seeds, **kw):
        return self._train(
            "cohort", lambda: self._orig["local_train_cohort"](
                start_params, client_ids, rnd_seeds, **kw),
            [int(c) for c in client_ids], [int(s) for s in rnd_seeds])

    def _step(self, params, opt_state, *a, **kw):
        """The trainer's optimizer step: the first step of a judged call
        leaves Adam's first moment, the gradient times ``1 - b1``, for
        the picked rows."""
        out = self._orig["_step_impl"](params, opt_state, *a, **kw)
        if self._step_rows:
            m, rows = out[1]["m"], self._step_rows
            self._first = self._copies(
                lambda: {i: host(row_of(m, i)) for i in rows})
            self._step_rows = None
        return out

    def _evaluate(self, params, *a, **kw):
        acc = self._orig["evaluate"](params, *a, **kw)
        rnd = self._round()
        copies = [c for c in self.calls if "row_copies" in c]
        needed = None
        if copies or rnd <= self.warmup or (self._sampled(rnd)
                                            and not self.calls):
            needed = {rnd - 1}
            for c in self.calls:
                needed |= {self.method.start_round(rnd, s, i)
                           for s, i in zip(c["seeds"], c["ids"])}
            before = self._copies(lambda: {r: host(self._held(r))
                                           for r in sorted(needed)})
        g = self._keep(rnd, params)
        if needed is not None:
            self.captured[rnd] = {"before": before,
                                  "after": self._copies(lambda: host(g))}
        t = time.perf_counter()
        self.rounds.append({"calls": self.calls, "acc": float(acc), "t": t})
        self.calls = []
        if rnd == self.warmup:
            self.t_start = t
            self.on_window("start", rnd)
        elif rnd > self.warmup:
            self.on_window("round", rnd)
            if t - self.t_start - self.copy_s["window"] >= self.seconds:
                self.t_end = t
                self.run_cfg.target_accuracy = -1.0
                self.on_window("stop", rnd)
        return acc

    # -- what the window did ----------------------------------------------
    def window_rounds(self) -> List[Dict]:
        return self.rounds[self.warmup:]


def warm_shapes(trainer, cell: Dict, seed: int, device):
    """Every cohort shape the traffic can give, once, before the run:
    the engine pads a cohort to a power of two, so a round trains 1, 2,
    4, ... rows up to the padding of ``tau`` clients from every tier
    (the largest round of all is warmed as it is: ``tau * tiers`` live
    rows), each as the method's rounds train it (``methods/``).  The
    first time the program meets a shape (cuBLAS's choice, the
    allocator's growth) is then set-up, and the run's peak memory is the
    largest cohort's whatever the seed makes of the schedule."""
    tr = cell["traffic"]
    params = trainer.init_params(seed)
    most = min(tr["tau"] * tr["tiers"], tr["clients"])
    sizes = [1 << k for k in range((most - 1).bit_length())] + [most]
    cell["method"].warm(trainer, tr, params, sizes)
    if device.type == "cuda":
        torch.cuda.synchronize()


def samples_per_update(tr: Dict) -> int:
    b = tr["batch_size"]
    return max(tr["samples_per_client"] // b, 1) * b * tr["local_epochs"]


def run_program(cell: Dict, seed: int, seconds: float, device,
                t_process: float, tracer=None, replace=None) -> Dict:
    """Set-up, warm-up and the window of one run; returns what the
    check and the metrics read.  ``tracer`` (trace.Tracer) adds the
    program's telemetry and the profiler; ``replace(trainer, cell,
    inputs)`` swaps a part of the program before the run (the control
    and the planted faults of ``flbench/tests``)."""
    import repro_torch.core.baselines  # noqa: F401 (the program's imports)
    tr = cell["traffic"]
    marks = [("imports", time.perf_counter())]
    inputs = make_inputs(cell, seed)
    marks.append(("inputs", time.perf_counter()))
    trainer, fl = build_trainer(cell, inputs, seed, device)
    if replace is not None:
        replace(trainer, cell, inputs)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    marks.append(("trainer", time.perf_counter()))
    warm_shapes(trainer, cell, seed, device)
    marks.append(("shapes", time.perf_counter()))
    run_cfg = _RunConfig(fl)
    rec = Recorder(trainer, cell, seed, seconds, run_cfg,
                   on_window=None if tracer is None else tracer.on_window,
                   quiet=0 if tracer is None else tracer.n_profile)
    if tracer is not None:
        tracer.begin(rec)
    hist = cell["method"].run(trainer, inputs["net"], run_cfg, tr)
    if tracer is not None:
        tracer.finish()
    if rec.t_end is None:
        raise RuntimeError("the run ended before its window closed: raise "
                           "the traffic's rounds")
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)
    window = rec.window_rounds()
    live = sum(c["live"] for r in window for c in r["calls"])
    span = rec.t_end - rec.t_start - rec.copy_s["window"]
    marks.append(("warmup_rounds", rec.t_start))
    split, prev = {}, t_process
    for name, t in marks:
        split[name] = t - prev
        prev = t
    split["warmup_rounds"] -= rec.copy_s["setup"]
    out = {"inputs": inputs, "hist": hist, "rec": rec, "peak": peak,
           "setup_s": rec.t_start - t_process - rec.copy_s["setup"],
           "setup_split": split, "copy_s": dict(rec.copy_s),
           "window_s": span,
           "rounds": len(window), "attempted": live,
           "samples_per_s": live * samples_per_update(tr) / span}
    rec.release()
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out
