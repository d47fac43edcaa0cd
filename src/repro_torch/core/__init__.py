from repro_torch.core.aggregation import (aggregate_or_keep,
                                          weighted_average,
                                          weighted_average_stacked)
from repro_torch.core.baselines import (run_fedavg, run_fedprox, run_method,
                                        run_tifl)
from repro_torch.core.engine import BatchedClientEngine, make_engine
from repro_torch.core.scheduler import run_feddct
from repro_torch.core.selection import (cstt, move_tier, select_from_tier,
                                        tier_timeouts)
from repro_torch.core.tiering import evaluate_client, tiering, update_avg_time

__all__ = [
    "tiering", "update_avg_time", "evaluate_client",
    "cstt", "tier_timeouts", "move_tier", "select_from_tier",
    "aggregate_or_keep", "weighted_average", "weighted_average_stacked",
    "BatchedClientEngine", "make_engine",
    "run_feddct", "run_fedavg", "run_tifl", "run_fedprox", "run_method",
]
