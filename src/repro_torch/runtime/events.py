"""Deterministic event queue for the virtual-clock async runtime.

Every FL method in this repo is compared on the *identical*
``WirelessNetwork`` realization, so the event order must be a pure
function of the sampled delays: events are a min-heap over
``(finish_time, client)`` — finish-time ties break on the lower client
id, never on heap insertion order.  The payload fields (model version
at start, per-client round index, sampled cost) do not participate in
ordering.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass(frozen=True, order=True)
class ClientEvent:
    """One client finishing its local training at virtual ``finish``.

    ``version`` is the global model version the client STARTED from
    (its staleness at merge time is ``current_version - version``);
    ``rnd`` is the client's own round counter (seeds its data stream);
    ``cost`` is the sampled wall-clock of this attempt (== the delay
    draw that produced ``finish``), kept for schedulers that maintain
    running-average client times.
    """

    finish: float
    client: int
    version: int = field(default=0, compare=False)
    rnd: int = field(default=0, compare=False)
    cost: float = field(default=0.0, compare=False)


class EventQueue:
    """Min-heap of ``ClientEvent`` with deterministic tie-breaking."""

    def __init__(self, events: Optional[List[ClientEvent]] = None):
        self._heap: List[ClientEvent] = list(events or [])
        heapq.heapify(self._heap)

    def push(self, event: ClientEvent) -> None:
        heapq.heappush(self._heap, event)

    def pop(self) -> ClientEvent:
        return heapq.heappop(self._heap)

    def peek(self) -> ClientEvent:
        return self._heap[0]

    def peek_n(self, k: int) -> List[ClientEvent]:
        """The ``k`` earliest pending events in pop order, WITHOUT
        popping — the residency prefetcher's lookahead.  ``heapq.
        nsmallest`` sorts on the same ``(finish, client)`` total order
        as ``pop``, so the returned prefix matches the next ``k`` pops
        exactly and the heap is untouched."""
        if k <= 0:
            return []
        return heapq.nsmallest(k, self._heap)

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
