"""The control of the correctness check: the reference in the program's
place, computed in TF32.

The configurations state float32 with TF32 off.  The control takes
every local step with the plain reference (``reference/model.py``) with
TF32 products (operands, results and the gradients that flow back
rounded to TF32's 10 mantissa bits) in the trainer's optimizer step;
the program's batching, engine, merges and scheduler run around it.
The run's check must then come out not correct.  ``flbench/tests`` keeps
this at a test's size; on the card, at a cell's own size and seeds:

    python3 flbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 10 [--sound]

prints, for each seed, every number the check compared beside its limit
(``--sound``: the program itself, for the lower readings; ``--fault
NAME``: the program with one of ``FAULTS`` planted); ``--rows FILE``
adds a line a seed to FILE with the row-by-row readings behind
``grad_gap`` and ``update_gap`` and the judged rounds' sizes.  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from flbench import bench  # noqa: E402
from flbench.reference import model  # noqa: E402


def _tree_like(template, named, prefix=""):
    """``named`` (dotted name -> tensor) in the nested layout of
    ``template``.  (Plain recursion: a self-referring closure would make
    a reference cycle that keeps ``named``'s tensors alive until the
    cyclic collector runs, three cohort-sized copies a step.)"""
    if isinstance(template, dict):
        return {k: _tree_like(v, named, f"{prefix}{k}.")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_tree_like(v, named, f"{prefix}{i}.")
                for i, v in enumerate(template)]
    return named[prefix[:-1]]


class ReferenceStep:
    """The trainer's optimizer step replaced by the reference's: the
    cohort's gradients from the family's reference (``reference``;
    ``reference/model.py`` for the CNN family), in TF32 with
    ``tf32=True``, and the reference's Adam, on the trainer's own
    parameters, optimizer state and batches.  Everything around the step
    (the batches' staging, the engine, the merges, the scheduler) stays
    the program's."""

    def __init__(self, trainer, cfg, tr, tf32: bool = True,
                 rows: int = 64, reference=model):
        self.cfg, self.tf32, self.rows = cfg, tf32, rows
        self.model = reference
        self.adam = reference.Adam(tr["lr"])
        trainer._step_impl = self

    def __call__(self, params, opt_state, x, y, im2col: bool = True):
        """One step of the batched path: ``params`` and ``opt_state``
        stacked over the cohort, ``x`` (C, B, H, W, c), ``y`` (C, B).
        The cohort is stepped ``rows`` clients at a time into the new
        state, so that a wide cohort's temporaries fit beside the
        program's own."""
        p = dict(bench.named_leaves(params))
        m = dict(bench.named_leaves(opt_state["m"]))
        v = dict(bench.named_leaves(opt_state["v"]))
        t = int(opt_state["t"]) + 1
        new = [{k: torch.empty_like(a) for k, a in d.items()}
               for d in (p, m, v)]
        for i in range(0, x.shape[0], self.rows):
            block = slice(i, i + self.rows)
            pb = {k: a[block] for k, a in p.items()}
            grads = self.model.gradients(self.cfg, pb, x[block].float(),
                                    y[block].long(), tf32=self.tf32)
            out = self.adam.step(pb, grads, {k: a[block] for k, a in m.items()},
                                 {k: a[block] for k, a in v.items()}, t)
            for dst, src in zip(new, out):
                for k, a in src.items():
                    dst[k][block] = a
            del grads, out
        p, m, v = new
        state = {"m": _tree_like(opt_state["m"], m),
                 "v": _tree_like(opt_state["v"], v),
                 "t": opt_state["t"] + 1}
        return _tree_like(params, p), state, torch.zeros(())


# Planted faults: each a ``replace(trainer, cell, inputs, patch)`` that
# breaks the timed path underneath a run (``patch(obj, name, value)``
# sets an attribute of the program for the run).  One card holds a
# cell, so no exchange between cards can be left out.

def unchanged(trainer, cell, inputs, patch):
    """A step that returns the model and its optimizer state unchanged."""
    patch(trainer, "_step_impl", lambda params, opt_state, x, y,
          im2col=False: (params, opt_state, torch.zeros(())))


def half_left_out(trainer, cell, inputs, patch):
    """Half of each cohort left out of the merge, the mean taken over the
    rest (the sync rounds' weights, the async windows' coefficients)."""
    import numpy as np

    from repro_torch.core import engine
    avg, fold = engine.aggregate_or_keep, engine.staleness_merge_coefficients

    def half_avg(params, stacked, weights, **kw):
        w = np.asarray(weights, np.float32).copy()
        w[(len(w) + 1) // 2:] = 0.0
        return avg(params, stacked, w, **kw)

    def half_fold(alphas):
        c = fold(alphas).copy()
        c[1 + (len(c) - 1 + 1) // 2:] = 0.0
        return c
    patch(engine, "aggregate_or_keep", half_avg)
    patch(engine, "staleness_merge_coefficients", half_fold)


def model_altered(trainer, cell, inputs, patch):
    """The merged global model altered where it is produced: one weight
    in ten moved by the leaf's mean size."""
    real = trainer.evaluate

    def evaluate(params, *a, **kw):
        for _, t in bench.named_leaves(params):
            flat = t.view(-1)
            flat[::10] += flat.abs().mean()
        return real(params, *a, **kw)
    patch(trainer, "evaluate", evaluate)


def accuracy_altered(trainer, cell, inputs, patch):
    """The reported accuracy altered by one test image in 64."""
    real = trainer.evaluate
    patch(trainer, "evaluate", lambda params, *a, **kw: min(
        real(params, *a, **kw) + 1.0 / 64, 1.0))


FAULTS = {f.__name__: f for f in (unchanged, half_left_out, model_altered,
                                  accuracy_altered)}


def readings(root: Path, workload: str, seeds, seconds: float, device,
             sound: bool = False, fault: str = "", rows: str = ""):
    """Per seed, the check's numbers of a run with the control in the
    program's place (``sound``: the program itself; ``fault``: the
    program with that fault planted); ``rows``: a file that gets each
    seed's row-by-row readings."""
    from flbench import run
    out = []
    for seed in seeds:
        if sound:
            replace = None
        elif fault:
            def replace(trainer, cell, inputs):
                FAULTS[fault](trainer, cell, inputs, setattr)
        else:
            def replace(trainer, cell, inputs):
                ReferenceStep(trainer, cell["config"], cell["traffic"],
                              reference=cell["family"].reference)
        detail = {}
        res = run.execute(root, workload, seed, seconds, False, device,
                          time.perf_counter(), replace=replace,
                          detail=detail)
        out.append({"seed": seed, "correct": res["correct"],
                    "checks": res["checks"]})
        if rows:
            kind = "sound" if sound else (fault or "control")
            with open(rows, "a") as f:
                f.write(json.dumps({"workload": workload, "kind": kind,
                                    "seed": seed, **detail}) + "\n")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--sound", action="store_true")
    ap.add_argument("--fault", choices=sorted(FAULTS), default="")
    ap.add_argument("--rows", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    for r in readings(Path.cwd(), args.workload, seeds, args.seconds,
                      torch.device("cuda"), sound=args.sound,
                      fault=args.fault, rows=args.rows):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
