"""FL-semantic labeled metric streams over the generic telemetry.

PR 7's spans/counters answer "where did the host's time go"; this layer
answers the questions the paper's evaluation actually asks — which tier
did a client sit in at round R, how often did tiers migrate, how close
did each tier run to its timeout threshold, who got starved by
selection, and how stale were the merged updates.  Every record lands
in the SAME ``Telemetry`` registries (counters / gauges / histograms)
under a labeled name, so the existing exporters, the validator, the
``meta["telemetry"]`` fold and the phase blocks in ``BENCH_*.json``
carry the FL view for free; ``repro_torch.obs.report`` folds it into the
paper-Table-2-style per-tier report.

Label encoding: ``base{k=v,k2=v2}`` with sorted keys — flat strings,
so the registries stay plain dicts.  ``parse_label`` inverts it.

Contract (same as the rest of ``repro_torch.obs``):

* zero overhead when disabled — every ``record_*`` first reads
  ``obs.TEL`` and returns before ANY formatting or math when tracing
  is off (call sites that would build an argument list guard on
  ``TEL.enabled`` themselves);
* numerically invisible when enabled — records only ever READ run
  state (the one device computation, the cohort update norm, is a pure
  reduction of values the run already produced);
* hard cardinality caps — labeled streams are LOW-cardinality by
  construction (tiers, tier pairs); the one per-client stream is
  capped at ``MAX_CLIENT_LABELS`` distinct clients and overflow is
  counted as ``telemetry.dropped_fl_labels``, never silent.

Catalogue (all tier labels are 1-indexed):

==========================================  ===============================
counter ``fl.tier.selected{tier=}``          selections per tier
counter ``fl.tier.participate{tier=}``       made the tier threshold/window
counter ``fl.tier.timeout{tier=}``           hit the tier timeout
counter ``fl.tier.migration{from=,to=}``     round-indexed migration matrix
counter ``fl.tier.rounds``                   tiering invocations
counter ``fl.straggler.carried{tier=}``      async: merged late, not lost
counter ``fl.straggler.dropped{tier=}``      sync: update discarded
counter ``fl.client.selected{client=}``      per-client selection counts
counter ``fl.client.update{client=}``        per-client merged updates
counter ``fl.bytes.up``(+``{tier=}``)        modeled uplink bytes (wire
                                             format: int8+meta or f32)
gauge   ``fl.population``                    total client count
gauge   ``fl.tier.count``                    number of tiers this round
gauge   ``fl.tier.size{tier=}``              membership time series
gauge   ``fl.tier.threshold_s{tier=}``       per-round threshold series
hist    ``fl.response_s{tier=}``             response-time distribution
hist    ``fl.response_frac{tier=}``          response / threshold headroom
hist    ``fl.threshold_s{tier=}``            threshold distribution
hist    ``fl.staleness``(+``{tier=}``)       merged-update staleness
hist    ``fl.cohort.update_norm``            per-cohort update L2 norm
==========================================  ===============================
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

from repro_torch.obs import telemetry as obs

# distinct label strings allowed per base metric name; the per-client
# streams get a wider budget (they are the one intentionally-per-entity
# series), everything else is tier-shaped and tiny.
MAX_LABELS_PER_METRIC = 64
MAX_CLIENT_LABELS = 4096
_CLIENT_METRICS = ("fl.client.selected", "fl.client.update")

DROPPED = "telemetry.dropped_fl_labels"


def label(base: str, **labels) -> str:
    """``label("fl.tier.size", tier=2) -> "fl.tier.size{tier=2}"``."""
    if not labels:
        return base
    body = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{base}{{{body}}}"


def parse_label(name: str) -> Tuple[str, Dict[str, str]]:
    """Inverse of ``label`` (labels come back as strings)."""
    if not name.endswith("}") or "{" not in name:
        return name, {}
    base, _, body = name.partition("{")
    out = {}
    for kv in body[:-1].split(","):
        k, _, v = kv.partition("=")
        out[k] = v
    return base, out


def _admit(tel, base: str, name: str) -> bool:
    """Cardinality gate: may ``name`` (one label string of ``base``) be
    recorded?  Admitted names are remembered on the recording
    ``Telemetry`` instance (every ``tracing()`` block starts fresh);
    an over-cap name is counted as ``telemetry.dropped_fl_labels``."""
    seen = getattr(tel, "_fl_label_sets", None)
    if seen is None:
        seen = tel._fl_label_sets = {}
    names = seen.setdefault(base, set())
    if name in names:
        return True
    cap = (MAX_CLIENT_LABELS if base in _CLIENT_METRICS
           else MAX_LABELS_PER_METRIC)
    if len(names) >= cap:
        tel.inc(DROPPED)
        return False
    names.add(name)
    return True


def _inc(tel, base: str, n=1, **labels):
    name = label(base, **labels)
    if _admit(tel, base, name):
        tel.inc(name, n)


def _observe(tel, base: str, value, **labels):
    name = label(base, **labels)
    if _admit(tel, base, name):
        tel.observe(name, value)


def _gauge(tel, base: str, value, **labels):
    name = label(base, **labels)
    if _admit(tel, base, name):
        tel.gauge(name, value)


# ---------------------------------------------------------------------------
# recording hooks (each early-returns when tracing is off)
# ---------------------------------------------------------------------------

def record_tiering(tiers, thresholds: Optional[Sequence[float]] = None,
                   population: int = 0):
    """One round's (re-)tiering: membership sizes, the round-indexed
    migration matrix (diffed against the last round on a per-run
    ``TierMigrationTracker``), and the per-tier timeout-threshold
    series when the caller knows it."""
    tel = obs.TEL
    if not tel.enabled:
        return
    from repro_torch.core.tiering import TierMigrationTracker
    tracker = getattr(tel, "_fl_tier_tracker", None)
    if tracker is None:
        tracker = tel._fl_tier_tracker = TierMigrationTracker()
    moves = tracker.update(tiers)
    for (t_old, t_new), n in moves.items():
        _inc(tel, "fl.tier.migration", n, **{"from": t_old, "to": t_new})
    tel.inc("fl.tier.rounds")
    tel.gauge("fl.tier.count", len(tiers))
    if population:
        tel.gauge("fl.population", population)
    for k, members in enumerate(tiers):
        _gauge(tel, "fl.tier.size", len(members), tier=k + 1)
    if thresholds is not None:
        for k, d in enumerate(thresholds):
            _gauge(tel, "fl.tier.threshold_s", d, tier=k + 1)
            _observe(tel, "fl.threshold_s", float(d), tier=k + 1)


def record_selection(selected, population: int = 0):
    """One round's selection.  ``selected`` is either plain client ids
    or the CSTT ``(client, tier_idx0)`` pairs; pairs also feed the
    per-tier selection counters."""
    tel = obs.TEL
    if not tel.enabled:
        return
    if population:
        tel.gauge("fl.population", population)
    for item in selected:
        if isinstance(item, tuple):
            c, k = item
            _inc(tel, "fl.tier.selected", tier=k + 1)
        else:
            c = item
        _inc(tel, "fl.client.selected", client=int(c))


def record_response(tier: int, response_s: float, threshold_s: float,
                    timed_out: bool):
    """One selected client's response time against its tier's assigned
    timeout threshold (``tier`` is 1-indexed)."""
    tel = obs.TEL
    if not tel.enabled:
        return
    _observe(tel, "fl.response_s", float(response_s), tier=tier)
    if threshold_s > 0:
        _observe(tel, "fl.response_frac",
                 float(response_s) / float(threshold_s), tier=tier)
    _inc(tel, "fl.tier.timeout" if timed_out else "fl.tier.participate",
         tier=tier)


def record_staleness(stalenesses: Iterable[int],
                     tiers: Optional[Iterable[Optional[int]]] = None):
    """Staleness of one merged window's rows; ``tiers`` (1-indexed, or
    ``None`` per row) adds the per-tier histograms when the runner
    knows which tier each completion was selected from."""
    tel = obs.TEL
    if not tel.enabled:
        return
    tiers = list(tiers) if tiers is not None else None
    for i, s in enumerate(stalenesses):
        tel.observe("fl.staleness", float(s))
        t = tiers[i] if tiers is not None else None
        if t is not None:
            _observe(tel, "fl.staleness", float(s), tier=t)


def record_straggler(kind: str, tier: Optional[int] = None, n: int = 1):
    """``kind`` "carried" (async: merged after its round) or "dropped"
    (sync: update discarded at the tier timeout)."""
    tel = obs.TEL
    if not tel.enabled:
        return
    if tier is None:
        tel.inc(f"fl.straggler.{kind}", n)
    else:
        _inc(tel, f"fl.straggler.{kind}", n, tier=tier)


def record_uplink(nbytes: int, tier: Optional[int] = None):
    """Modeled uplink bytes of merged client updates — ``nbytes`` is
    the wire size of the updates that landed this window (row format
    dependent: int8+meta under ``quant_bits=8``, full f32 otherwise).
    Labeled per 1-indexed tier when the runner knows it (feddct_async);
    the plain counter otherwise (fedasync/fedbuff)."""
    tel = obs.TEL
    if not tel.enabled or nbytes <= 0:
        return
    if tier is None:
        tel.inc("fl.bytes.up", int(nbytes))
    else:
        _inc(tel, "fl.bytes.up", int(nbytes), tier=tier)


def record_client_updates(client_ids: Iterable[int]):
    """Clients whose update actually merged this window (the async
    runners' participation stream)."""
    tel = obs.TEL
    if not tel.enabled:
        return
    for c in client_ids:
        _inc(tel, "fl.client.update", client=int(c))


def record_update_norm(stacked, n_rows: int):
    """L2 norm of one drained cohort's stacked update rows (the first
    ``n_rows`` — the rest are pad duplicates).  Pure read of values the
    run already produced.  The squared rows are summed on their device
    into one f32 scalar a window, and the scalar is observed
    UNRESOLVED: ``Telemetry.summary`` reads every pending value back
    at once, so tracing adds no host sync inside a round."""
    tel = obs.TEL
    if not tel.enabled or stacked is None or n_rows <= 0:
        return
    from repro_torch.tree import tree_leaves
    total = None
    for leaf in tree_leaves(stacked):
        rows = leaf[:n_rows].float()
        part = (rows * rows).sum()
        total = part if total is None else total + part
    tel.observe("fl.cohort.update_norm", total.sqrt())
