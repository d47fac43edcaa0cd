"""Aggregation buffer: windowed draining of client completions.

The knob that spans the async design space:

* ``window=0, window_secs=0`` — every drain returns exactly ONE event:
  the degenerate case is today's one-at-a-time FedAsync merge.
* ``window=K`` — FedBuff-style count window: the drain collects the K
  earliest completions (the server waits for a goal number of updates
  before aggregating).
* ``window_secs=T`` — time window: the drain anchors on the earliest
  pending completion and collects everything finishing within T
  virtual seconds of it (Zhou et al.'s time-triggered batching).
* both — count cap AND time deadline, whichever closes first.

``drain_until`` is the externally-anchored variant used by the
semi-async FedDCT loop, where a per-tier timeout (Eq. 7) — not the
anchor event — sets the deadline.
"""

from __future__ import annotations

import math
from typing import List, Optional

from repro_torch.obs import telemetry as obs
from repro_torch.runtime.events import ClientEvent, EventQueue


class AggregationBuffer:
    def __init__(self, window: int = 0, window_secs: float = 0.0):
        if window < 0 or window_secs < 0:
            raise ValueError("window and window_secs must be >= 0")
        self.window = int(window)
        self.window_secs = float(window_secs)

    def _cap(self, limit: Optional[int]) -> float:
        if self.window > 0:
            cap = self.window
        elif self.window_secs > 0:
            cap = math.inf
        else:
            cap = 1                       # sequential FedAsync
        return cap if limit is None else min(cap, limit)

    def drain(self, queue: EventQueue,
              limit: Optional[int] = None) -> List[ClientEvent]:
        """Pop one window of completions (>= 1 event; the anchor is the
        earliest pending completion).  ``limit`` hard-caps the count
        (the runner's remaining update budget)."""
        tel = obs.TEL
        tel.gauge("queue.depth", len(queue))
        if not queue:
            tel.inc("drain.queue_empty")
            return []
        anchor = queue.pop()
        batch = [anchor]
        cap = self._cap(limit)
        deadline = (anchor.finish + self.window_secs
                    if self.window_secs > 0 else math.inf)
        while queue and len(batch) < cap and queue.peek().finish <= deadline:
            batch.append(queue.pop())
        # classify what closed the window (counter catalogue: drain.*)
        if len(batch) >= cap:
            if limit is not None and cap == limit and (
                    self.window == 0 or limit < self.window):
                tel.inc("drain.budget")
            elif self.window > 0:
                tel.inc("drain.count")
            else:
                tel.inc("drain.sequential")
        elif self.window_secs > 0:
            tel.inc("drain.deadline")
        else:
            tel.inc("drain.queue_drained")
        return batch

    def peek_window(self, queue: EventQueue,
                    limit: Optional[int] = None) -> List[ClientEvent]:
        """The events the NEXT ``drain`` would return, without popping
        — the residency prefetcher's lookahead.  Mirrors ``drain``'s
        anchor/cap/deadline logic over ``peek_n``'s sorted prefix, so
        the result matches the coming drain exactly (events pushed in
        between can only make the real drain a sub-case: gather/merge
        re-stage anything the prefetch missed)."""
        if not queue:
            return []
        cap = self._cap(limit)
        k = len(queue) if math.isinf(cap) else min(int(cap), len(queue))
        events = queue.peek_n(k)
        if self.window_secs > 0:
            deadline = events[0].finish + self.window_secs
            events = [e for e in events if e.finish <= deadline]
        return events

    def close_time(self, batch: List[ClientEvent],
                   limit: Optional[int] = None) -> float:
        """Virtual time at which the server actually closes a drained
        window.

        A count-closed window (the K-th / budget-capped completion
        arrived) closes at the last arrival.  A time-closed window
        closes at ``anchor + window_secs``: a real time-triggered
        server cannot know no further completion is coming, so it must
        wait out the full deadline even if the last arrival was
        earlier.
        """
        if self.window_secs > 0 and len(batch) < self._cap(limit):
            return batch[0].finish + self.window_secs
        return batch[-1].finish

    @staticmethod
    def drain_until(queue: EventQueue, deadline: float,
                    limit: Optional[int] = None) -> List[ClientEvent]:
        """Pop every completion with ``finish <= deadline`` (possibly
        none) — the semi-async FedDCT window, where the tier timeout
        sets the deadline before any event is seen."""
        tel = obs.TEL
        tel.gauge("queue.depth", len(queue))
        batch: List[ClientEvent] = []
        cap = math.inf if limit is None else limit
        while queue and len(batch) < cap and queue.peek().finish <= deadline:
            batch.append(queue.pop())
        if len(batch) >= cap:
            tel.inc("drain.budget")
        else:
            tel.inc("drain.deadline")
        return batch

    @staticmethod
    def peek_until(queue: EventQueue, deadline: float,
                   limit: Optional[int] = None) -> List[ClientEvent]:
        """The events the next ``drain_until(deadline)`` would return,
        without popping — lookahead for the semi-async FedDCT loop
        (the tier timeout is known BEFORE the window opens, so the
        whole coming window can prefetch)."""
        if not queue:
            return []
        k = len(queue) if limit is None else min(int(limit), len(queue))
        return [e for e in queue.peek_n(k) if e.finish <= deadline]
