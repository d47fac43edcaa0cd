from repro_torch.core.aggregation import (aggregate_or_keep,
                                          staleness_merge,
                                          staleness_merge_coefficients,
                                          staleness_weighted_merge,
                                          weighted_average,
                                          weighted_average_stacked)
from repro_torch.core.baselines import (run_fedasync,
                                        run_fedasync_sequential, run_fedavg,
                                        run_fedbuff, run_feddct_async,
                                        run_fedprox, run_method, run_tifl)
from repro_torch.core.engine import BatchedClientEngine, make_engine
from repro_torch.core.residency import TieredClientStateStore
from repro_torch.core.scheduler import run_feddct
from repro_torch.core.selection import (cstt, move_tier, select_from_tier,
                                        tier_timeouts)
from repro_torch.core.state import ClientStateStore, wire_bytes
from repro_torch.core.tiering import evaluate_client, tiering, update_avg_time

__all__ = [
    "tiering", "update_avg_time", "evaluate_client",
    "cstt", "tier_timeouts", "move_tier", "select_from_tier",
    "aggregate_or_keep", "weighted_average", "weighted_average_stacked",
    "staleness_merge", "staleness_merge_coefficients",
    "staleness_weighted_merge",
    "BatchedClientEngine", "make_engine", "ClientStateStore",
    "TieredClientStateStore", "wire_bytes",
    "run_feddct", "run_fedavg", "run_tifl", "run_fedprox", "run_fedasync",
    "run_fedasync_sequential", "run_fedbuff", "run_feddct_async",
    "run_method",
]
