"""What decides ``correct``: the run against the plain reference.

Once the window has closed and the program's state is freed, the
reference (``flbench/reference``, which imports nothing of the program)
recomputes from the benchmark's own inputs:

* the schedule of every round the run made (``schedule``): which
  clients trained with which data seeds, the tier pointer, the counts of
  selected clients and stragglers, and the virtual clock, each equal to
  what the run recorded (``sched_mismatch``, rounds that differ);
* the initial model from the seed (``init_gap``, largest difference);
* the warm-up rounds and a sample of the window's rounds drawn from the
  seed, each from the global models the program held when the round's
  updates started (the reference follows the program round by round
  from the program's own state: a run's small differences change its
  accuracies and so its later schedule), every update trained again:
  for ``check.rows`` picked updates of each round, the gradient of
  their first local step (``grad_gap``), and for every update whose
  trained model was copied (the picked ones, or with
  ``check.all_rows`` every live one) the size of each leaf's change
  over all its steps (``update_gap``), each read row by row and taken
  at the run's ``ROW_QUANTILE`` over those rows; the round's
  merged global model against the merge of the reference's updates
  (``agg_gap``) and, where the traffic copies every live row, against
  the reference's merge of the program's own updates (``merge_gap``:
  the merge alone, to rounding); and the accuracy the run reported,
  recounted on the program's global model of that round
  (``eval_gap``).  The reference's schedule and merge are the method's
  (``methods/``), its model the family's (``families/``).

A gap between two models (or gradients) is the norm of their
difference over the whole model, relative to the norm of the
reference's gradient, or of its updates' changes (leaf by leaf their
mean: updates of non-iid clients partly cancel in their merge, their
errors do not).  Trained models are not compared weight by weight: over
25-30 local Adam steps two correct float32 programs drift apart (the
program on the CPU and on the card read 5-25 % of ResNet8's update
apart, ``PERF.md``), since Adam moves a weight by ``lr`` whatever its
gradient's size and a rounding that flips a ReLU or a pooling choice
changes later gradients; so a trained model's change is judged by its
size, leaf by leaf, and precision by the first step's gradient.  Even
one gradient reads a rounding that flips a ReLU or a pooling choice
(up to 1.6e-3 against 1e-6 without one, on the card); such a flip hits
up to a third of the updates of a later round, TF32 products every one,
so the rows' median is compared.  So is the size of a change: in one
update in a few dozen of the async cell a leaf's change reads up to
twice the other side's (a channel alive in one and all but dead in the
other after a few Adam steps, whose gradient Adam turns into full
steps), while a step that leaves the model unchanged or moves it twice
reads 1 on every update.  Each number has a limit in the traffic file
(``limits``), set from sound runs and from the control (``PERF.md``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from flbench.reference import schedule

# the quantile of a run's judged rows that ``grad_gap`` and ``update_gap``
# take: the median, since in a trained model's later rounds up to a third
# of the sound rows carry a flipped ReLU or pooling choice (``PERF.md``)
ROW_QUANTILE = 0.5


def _shaped(vec: torch.Tensor, shapes) -> Dict[str, torch.Tensor]:
    out, off = {}, 0
    for name, shape in shapes:
        n = int(np.prod(shape))
        out[name] = vec[off:off + n].reshape(shape)
        off += n
    return out


def norms(a: Dict, b: Dict) -> Dict[str, float]:
    """Leaf by leaf, the norm of ``a - b``."""
    return {k: float(torch.linalg.vector_norm(a[k].double() - b[k].double()))
            for k in a}


def gap(prog: Dict, ref: Dict, scale: Dict[str, float]) -> float:
    """||prog - ref|| over the whole model, relative to the norm of the
    per-leaf ``scale`` over the whole model."""
    diff = norms(prog, ref)
    den = float(np.sqrt(sum(v * v for v in scale.values())))
    num = float(np.sqrt(sum(v * v for v in diff.values())))
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def mean_scale(models: List[Dict], starts: List[Dict]) -> Dict[str, float]:
    """Per leaf, the mean norm of the updates' changes."""
    each = [norms(m, s) for m, s in zip(models, starts)]
    return {k: float(np.mean([e[k] for e in each])) for k in each[0]}


def sched_mismatch(rec, hist, plan) -> int:
    """Rounds whose training calls or reported figures differ from the
    reference's schedule (and any round only one side has)."""
    bad = abs(len(rec.rounds) - len(plan))
    for r, (got, want) in enumerate(zip(rec.rounds, plan)):
        ids = [c for call in got["calls"] for c in call["ids"]]
        seeds = [s for call in got["calls"] for s in call["seeds"]]
        same = (ids == [c for c, _, _ in want["train"]]
                and seeds == [s for _, s, _ in want["train"]]
                and hist.times[r] == want["time"]
                and hist.tier[r] == want["tier"]
                and hist.n_selected[r] == want["selected"]
                and hist.n_stragglers[r] == want["stragglers"]
                and hist.rounds[r] == r + 1)
        bad += not same
    return bad


class _Cohorts:
    """The clients' batches on the device, and the reference's training
    of a cohort in blocks of at most ``rows`` clients."""

    def __init__(self, cfg, tr, inputs, device, model, rows=128):
        self.cfg, self.tr, self.inputs = cfg, tr, inputs
        self.device, self.rows, self.model = device, rows, model

    def data(self, members):
        tr, x, y = self.tr, self.inputs["x"], self.inputs["y"]
        xs, ys = [], []
        for c, s, _ in members:
            part = self.inputs["parts"][c]
            steps = schedule.client_batches(len(part), tr["batch_size"],
                                            tr["local_epochs"], s)
            idx = np.stack([part[b] for b in steps])
            xs.append(x[idx])
            ys.append(y[idx])
        return (torch.from_numpy(np.stack(xs)).to(self.device),
                torch.from_numpy(np.stack(ys)).long().to(self.device))

    def train(self, members, starts: List[Dict]):
        """-> (trained models, first-step gradients), one a member."""
        models, grads = [], []
        for i in range(0, len(members), self.rows):
            block = members[i:i + self.rows]
            xs, ys = self.data(block)
            st = self.model.stack([{k: t.to(self.device)
                                    for k, t in s.items()}
                                   for s in starts[i:i + self.rows]])
            done, first = self.model.train_cohort(self.cfg, st, xs, ys,
                                                  self.tr["lr"])
            models += [{k: t[j].cpu() for k, t in done.items()}
                       for j in range(len(block))]
            grads += [{k: t[j].cpu() for k, t in first.items()}
                      for j in range(len(block))]
        return models, grads


def update_gap(prog: Dict, ref: Dict, start: Dict) -> float:
    """Worst leaf of | ||prog - start|| - ||ref - start|| | over the
    larger of ||ref - start|| and the median leaf's: the size of a
    trained model's change, which a correct run keeps where its
    direction has drifted."""
    p, r = norms(prog, start), norms(ref, start)
    med = float(np.median(list(r.values())))
    return max(abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in r)


def judge(cell: Dict, seed: int, run: Dict, device,
          detail: Dict = None) -> Dict[str, float]:
    """The numbers compared, by name.  ``detail``, where given, gets the
    row-by-row readings (``grad_rows``, ``update_rows``) and the live
    rows of each judged round (``judged``: [round, live])."""
    cfg, tr = cell["config"], cell["traffic"]
    method, model = cell["method"], cell["family"].reference
    rec, hist, inputs = run["rec"], run["hist"], run["inputs"]
    accuracy = [r["acc"] for r in rec.rounds]
    plan = method.schedule(inputs["net"], tr, seed, accuracy)
    shapes = rec.shapes
    out = {"sched_mismatch": float(sched_mismatch(rec, hist, plan))}
    ref_init = model.init_params(cfg, seed)
    prog_init = _shaped(rec.init, shapes)
    out["init_gap"] = max(float((prog_init[k] - ref_init[k]).abs().max())
                          for k in ref_init)
    cohorts = _Cohorts(cfg, tr, inputs, device, model)
    x_test = torch.from_numpy(inputs["x_test"]).to(device)
    y_test = torch.from_numpy(inputs["y_test"]).long().to(device)
    b1 = model.Adam(tr["lr"]).b1
    agg_g = eval_g = merge_g = 0.0
    redone_rounds = 0
    grad_rows, upd_rows, judged = [], [], []
    for rnd in sorted(rec.captured):
        cap = rec.captured[rnd]
        want = plan[rnd - 1] if rnd <= len(plan) else {"train": []}
        held = {r: _shaped(v, shapes) for r, v in cap["before"].items()}
        members = want["train"]
        after = _shaped(cap["after"], shapes)
        judged.append([rnd, len(members)])
        if members:
            starts = [held[s] for _, _, s in members]
            trained, first = cohorts.train(members, starts)
            merged = method.merge(tr, held[rnd - 1], trained, want["alphas"])
            agg_g = max(agg_g, gap(after, merged,
                                   mean_scale(trained, starts)))
            pos, own = 0, []
            for call in rec.rounds[rnd - 1]["calls"]:
                rows = call.get("row_copies", {})
                for i in sorted(rows):
                    j = pos + i
                    upd_rows.append(update_gap(_shaped(rows[i], shapes),
                                               trained[j], starts[j]))
                for i in call.get("picks", []):
                    j = pos + i
                    m = call["first_m"].get(i)
                    g = ({k: t / (1.0 - b1) for k, t in
                          _shaped(m, shapes).items()} if m is not None
                         else None)
                    zero = {k: torch.zeros_like(t) for k, t in
                            first[j].items()}
                    grad_rows.append(float("inf") if g is None else
                                     gap(g, first[j], norms(first[j], zero)))
                own += ([_shaped(rows[i], shapes) for i in range(call["live"])]
                        if len(rows) == call["live"] else [None])
                pos += call["live"]
            if own and None not in own:
                redone = method.merge(tr, held[rnd - 1], own, want["alphas"])
                merge_g = max(merge_g, gap(after, redone,
                                           mean_scale(own, starts)))
                redone_rounds += 1
        elif any(not torch.equal(after[k], held[rnd - 1][k]) for k in after):
            agg_g = merge_g = float("inf")   # nothing merged, yet it moved
        hits = model.correct_count(
            cfg, {k: t.to(device) for k, t in after.items()}, x_test, y_test)
        eval_g = max(eval_g, abs(hits / len(y_test)
                                 - rec.rounds[rnd - 1]["acc"]))
    out.update(grad_gap=_quantile(grad_rows, ROW_QUANTILE),
               update_gap=_quantile(upd_rows, ROW_QUANTILE), agg_gap=agg_g,
               merge_gap=merge_g if redone_rounds else float("inf"),
               eval_gap=eval_g)
    out["rounds_checked"] = float(sum(1 for r in rec.captured
                                      if r > tr["warmup_rounds"]))
    if detail is not None:
        detail.update(grad_rows=grad_rows, update_rows=upd_rows,
                      judged=judged)
    return out


def _quantile(rows: List[float], q: float) -> float:
    """The rows' ``q`` quantile, read off one row (the higher of two);
    a NaN row counts as the largest."""
    if not rows:
        return float("inf")
    vals = [float("inf") if np.isnan(v) else v for v in rows]
    return float(np.quantile(vals, q, method="higher"))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every compared number within its limit, and at least one window
    round judged."""
    return numbers["rounds_checked"] >= 1 and all(
        numbers[k] <= v for k, v in limits.items())
