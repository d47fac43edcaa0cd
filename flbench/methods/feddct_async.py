"""Semi-async FedDCT: selection as the sync method's, each round's
timeouts an aggregation deadline, every completion that lands by it
merged with a staleness weight.  A data seed ``r * 977 + client`` marks
an update selected in round r, which started from round r - 1's global
model."""

from flbench.reference import merge as _merge
from flbench.reference import schedule as _schedule


def run(trainer, net, run_cfg, tr):
    """The program's run of the method (its history)."""
    from repro_torch.core.baselines import run_method
    kw = {"use_store": True} if tr["store"] == "device" else {}
    return run_method("feddct_async", trainer, net, run_cfg, **kw)


def start_round(rnd: int, seed: int, client: int) -> int:
    return (seed - client) // 977 - 1


def warm(trainer, tr, params, sizes):
    """A window's cohort of each size, padded to a power of two, from
    its own copies of the start model."""
    from repro_torch.tree import tree_map
    for n in sizes:
        rows = 1 << (n - 1).bit_length()
        starts = tree_map(lambda t: t.unsqueeze(0).expand(
            rows, *t.shape).contiguous(), params)
        trainer.local_train_cohort(starts, list(range(rows)),
                                   list(range(rows)))


def schedule(net, tr, seed, accuracy):
    return _schedule.feddct_async(net, tr, seed, accuracy)


def merge(tr, start, trained, alphas):
    return _merge.staleness_merge(start, trained, alphas)
