"""The documented telemetry name catalogue.

Every literal span/counter/gauge/histogram name recorded through
``obs.TEL`` must appear here — ``fedlint``'s FED004 rule machine-checks
call sites against these sets, so a typo'd or undocumented stream
cannot silently land in traces (the ROADMAP catalogue prose and this
module must move together; ``tests/test_fedlint.py`` cross-checks a
recorded run against it at runtime too).

Labeled FL-semantic streams (``repro_torch.obs.flstats``) record under
``base{k=v,...}`` names: the *base* is catalogued here, the label part
is stripped before the check (``flstats.parse_label`` inverts it).
Dynamic families that cannot be enumerated (``telemetry.dropped_*``
overflow counters) are admitted by prefix.

The port's counterpart of a backend compile is an ``nvcc`` build of a
kernel source: ``kernel.builds`` (counter) and ``kernel.build_s``
(hist), recorded by ``repro_torch.kernels._build`` while tracing is on.
"""

from __future__ import annotations

#: span names (see ROADMAP "Telemetry" for who records each)
SPANS = frozenset({
    "run",
    "round.select", "round.train", "round.aggregate",
    "window.stage", "window.gather", "window.train",
    "window.merge_scatter",
    "window.prefetch", "window.merge", "window.reschedule",
    "store.merge", "store.scatter",
    "residency.promote", "residency.write_behind",
    "residency.host_gather",
    "eval",
})

#: counters — plain runtime counters plus the flstats labeled BASES
COUNTERS = frozenset({
    "residency.demand_hit", "residency.demand_promote",
    "residency.prefetch_hit", "residency.prefetch_promote",
    "residency.write_behind", "residency.evict_clean",
    "residency.write_around", "residency.oversubscribed_gather",
    "lookahead.hit", "lookahead.miss",
    "drain.count", "drain.deadline", "drain.budget", "drain.sequential",
    "drain.queue_drained", "drain.queue_empty",
    "stragglers.carried", "stragglers.dropped",
    "store.donation_active", "store.donation_skipped",
    "kernel.builds",
    # flstats labeled bases (tier/client labels stripped before check)
    "fl.tier.selected", "fl.tier.participate", "fl.tier.timeout",
    "fl.tier.migration", "fl.tier.rounds",
    "fl.straggler.carried", "fl.straggler.dropped",
    "fl.client.selected", "fl.client.update",
    "fl.bytes.up",
})

#: open-ended counter families admitted by prefix
COUNTER_PREFIXES = ("telemetry.dropped_",)

GAUGES = frozenset({
    "queue.depth", "queue.inflight",
    "store.bytes_hot", "store.bytes_cold",
    "fl.population", "fl.tier.count", "fl.tier.size",
    "fl.tier.threshold_s",
})

HISTS = frozenset({
    "cohort.size", "kernel.build_s",
    "fl.response_s", "fl.response_frac", "fl.threshold_s",
    "fl.staleness", "fl.cohort.update_norm",
})

ALL = SPANS | COUNTERS | GAUGES | HISTS


def kind_of(name: str) -> str:
    """Catalogue kind of a recorded name ("span"/"counter"/"gauge"/
    "hist"), or "unknown".  Labels (``base{k=v}``) are stripped."""
    base = name.split("{", 1)[0]
    if base in SPANS:
        return "span"
    if base in COUNTERS or base.startswith(COUNTER_PREFIXES):
        return "counter"
    if base in GAUGES:
        return "gauge"
    if base in HISTS:
        return "hist"
    return "unknown"
