"""Event-driven async federation runtime (virtual clock).

Three pieces, composable from the bottom up:

* ``events``  — ``EventQueue``: a deterministic min-heap of client
  completions ordered by ``(finish_time, client)`` so every method
  replays the identical ``WirelessNetwork`` realization.
* ``buffer``  — ``AggregationBuffer``: drains completions in windows
  (``window=0`` = sequential FedAsync, ``window=K`` = FedBuff count
  goal, ``window_secs=T`` = time-triggered batching).
* ``async_loop`` — ``AsyncRunner`` (each drained window trains as one
  batched cohort, merged with per-row staleness weights through the
  folded merge) and ``run_feddct_async`` (FedDCT's per-tier timeouts
  reinterpreted as window deadlines).
"""

from repro_torch.runtime.async_loop import AsyncRunner, run_feddct_async
from repro_torch.runtime.buffer import AggregationBuffer
from repro_torch.runtime.events import ClientEvent, EventQueue

__all__ = ["AggregationBuffer", "ClientEvent", "EventQueue",
           "AsyncRunner", "run_feddct_async"]
