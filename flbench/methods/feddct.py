"""Sync FedDCT (arXiv 2307.04420, Alg. 2 with Algs. 3-4): every round's
survivors start from the previous round's global model, train as one
cohort and are averaged by sample count."""

from flbench.reference import merge as _merge
from flbench.reference import schedule as _schedule


def run(trainer, net, run_cfg, tr):
    """The program's run of the method (its history)."""
    from repro_torch.core.baselines import run_method
    kw = {"use_store": True} if tr["store"] == "device" else {}
    return run_method("feddct", trainer, net, run_cfg, **kw)


def start_round(rnd: int, seed: int, client: int) -> int:
    return rnd - 1


def warm(trainer, tr, params, sizes):
    """A round of each size through the program's engine (which pads a
    cohort to a power of two, trains it and aggregates its live rows)."""
    from repro_torch.core.engine import make_engine
    eng = make_engine(trainer)
    for n in sizes:
        eng.train_round(params, list(range(n)), 1)


def schedule(net, tr, seed, accuracy):
    return _schedule.feddct(net, tr, seed, accuracy)


def merge(tr, start, trained, alphas):
    return _merge.weighted_average(
        trained, [tr["samples_per_client"]] * len(trained))
