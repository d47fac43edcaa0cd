"""Fold a trace into the paper-Table-2-style per-tier run report.

The FedDCT evaluation tables slice a run by tier: how many clients
each tier contributed, how often a tier hit its timeout threshold,
how close responses ran to the assigned ``D_max``, and how the global
accuracy / virtual-time trajectory paid for those choices.  This
module rebuilds that view from any of the three places a traced run
lands its aggregate:

* a JSONL trace (``fl_train.py --trace run.jsonl``) — the trailing
  ``summary`` line;
* a Chrome trace (``--trace-format chrome``) —
  ``otherData.summary``;
* a saved ``RunHistory`` JSON (``--out hist.json``) —
  ``meta["telemetry"]`` (this source also carries the
  accuracy/virtual-time trajectory).

CLI::

    PYTHONPATH=src python -m repro_torch.obs.report run.jsonl
    PYTHONPATH=src python -m repro_torch.obs.report hist.json --json report.json

or in-process via ``fl_train.py --report [PATH]``.  Output is the text
table plus (optionally) the structured JSON report; exit status 2 when
the input carries no telemetry summary.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional, Tuple

from repro_torch.obs.flstats import parse_label


# ---------------------------------------------------------------------------
# loading: trace file / history file -> (summary dict, history dict|None)
# ---------------------------------------------------------------------------

def load_source(path: str) -> Tuple[Optional[Dict], Optional[Dict]]:
    """-> ``(telemetry_summary, run_history_dict)``; either may be
    ``None``.  Sniffs the three formats by shape, not extension."""
    with open(path) as f:
        first = f.readline()
        rest = f.read()
    try:
        head = json.loads(first)
    except json.JSONDecodeError:
        # a multi-line JSON document (chrome trace / pretty history)
        head = None
    if isinstance(head, dict) and head.get("type") == "meta" and rest:
        # JSONL trace: the summary is the trailing line
        summary = None
        for line in rest.splitlines():
            if not line.strip():
                continue
            rec = json.loads(line)
            if rec.get("type") == "summary":
                summary = {k: v for k, v in rec.items() if k != "type"}
        return summary, None
    doc = json.loads(first + rest)
    if "traceEvents" in doc:                       # chrome trace
        return doc.get("otherData", {}).get("summary"), None
    if "meta" in doc or "method" in doc:           # RunHistory JSON
        return doc.get("meta", {}).get("telemetry"), doc
    if "counters" in doc and "hists" in doc:       # bare summary dict
        return doc, None
    return None, None


# ---------------------------------------------------------------------------
# report construction
# ---------------------------------------------------------------------------

def _labeled(table: Dict, base: str, key: str = "tier") -> Dict[int, object]:
    """All ``base{key=v}`` entries of a counters/gauges/hists table,
    keyed by the int label value."""
    out = {}
    for name, value in table.items():
        b, labels = parse_label(name)
        if b == base and key in labels:
            out[int(labels[key])] = value
    return out


def build_report(summary: Dict, history: Optional[Dict] = None) -> Dict:
    """Fold one telemetry summary (+ optional ``RunHistory`` dict) into
    the structured per-tier report."""
    counters = summary.get("counters", {})
    gauges = summary.get("gauges", {})
    hists = summary.get("hists", {})

    selected = _labeled(counters, "fl.tier.selected")
    participated = _labeled(counters, "fl.tier.participate")
    timeouts = _labeled(counters, "fl.tier.timeout")
    carried = _labeled(counters, "fl.straggler.carried")
    dropped = _labeled(counters, "fl.straggler.dropped")
    sizes = _labeled(gauges, "fl.tier.size")
    thr_gauge = _labeled(gauges, "fl.tier.threshold_s")
    resp = _labeled(hists, "fl.response_s")
    frac = _labeled(hists, "fl.response_frac")
    thr = _labeled(hists, "fl.threshold_s")
    stale = _labeled(hists, "fl.staleness")
    uplink = _labeled(counters, "fl.bytes.up")
    n_rounds = int(counters.get("fl.tier.rounds", 0))

    tier_ids = sorted(set(selected) | set(participated) | set(timeouts)
                      | set(sizes) | set(resp) | set(uplink))
    tiers = {}
    for t in tier_ids:
        part = int(participated.get(t, 0))
        hits = int(timeouts.get(t, 0))
        seen = part + hits
        row = {
            "selected": int(selected.get(t, 0)),
            "participated": part,
            "timeout_hits": hits,
            "timeout_hit_rate": (hits / seen) if seen else 0.0,
            "carried": int(carried.get(t, 0)),
            "dropped": int(dropped.get(t, 0)),
        }
        if t in sizes:
            row["size_last"] = int(sizes[t])
        r = resp.get(t)
        if r:
            row["mean_response_s"] = r["mean"]
            row["p95_response_s"] = r["p95"]
        d = thr.get(t)
        if d:
            row["mean_threshold_s"] = d["mean"]
        elif t in thr_gauge:
            row["mean_threshold_s"] = thr_gauge[t]
        fr = frac.get(t)
        if fr:
            row["mean_response_frac"] = fr["mean"]
        st = stale.get(t)
        if st:
            row["staleness_mean"] = st["mean"]
            row["staleness_p95"] = st["p95"]
        # communication volume (PR 9 ``fl.bytes.up{tier=}`` counters);
        # traces from older runs simply have no entry -> "-" columns
        if t in uplink:
            b = int(uplink[t])
            row["uplink_bytes"] = b
            row["uplink_mb"] = b / 1e6
            if n_rounds:
                row["uplink_bytes_per_round"] = b / n_rounds
        tiers[t] = row

    migrations = {}
    for name, n in counters.items():
        base, labels = parse_label(name)
        if base == "fl.tier.migration":
            migrations[f"{labels['from']}->{labels['to']}"] = int(n)

    population = int(gauges.get("fl.population", 0))
    sel_counts = {c: n for c, n in
                  _labeled(counters, "fl.client.selected", "client").items()}
    upd_counts = {c: n for c, n in
                  _labeled(counters, "fl.client.update", "client").items()}
    fairness = {}
    if sel_counts or population:
        from repro_torch.core.selection import participation_fairness
        fairness["selection"] = participation_fairness(sel_counts,
                                                       population)
        if upd_counts:
            fairness["updates"] = participation_fairness(upd_counts,
                                                         population)

    report = {
        "rounds": int(counters.get("fl.tier.rounds", 0)),
        "population": population,
        "tiers": tiers,
        "migration_matrix": migrations,
        "n_migrations": sum(migrations.values()),
        "fairness": fairness,
        "stragglers": {
            "carried": int(sum(carried.values())
                           + counters.get("fl.straggler.carried", 0)),
            "dropped": int(sum(dropped.values())
                           + counters.get("fl.straggler.dropped", 0)),
        },
        "dropped_labels": int(counters.get("telemetry.dropped_fl_labels",
                                           0)),
        "wall_s": summary.get("wall_s"),
    }
    total_up = int(sum(uplink.values())
                   + counters.get("fl.bytes.up", 0))
    if total_up:
        report["uplink"] = {
            "total_bytes": total_up,
            "total_mb": total_up / 1e6,
            "bytes_per_round": (total_up / n_rounds) if n_rounds else None,
        }
    norm = hists.get("fl.cohort.update_norm")
    if norm:
        report["cohort_update_norm"] = norm
    if history is not None:
        acc = history.get("accuracy") or []
        times = history.get("times") or []
        report["trajectory"] = {
            "method": history.get("method"),
            "evals": len(acc),
            "final_accuracy": acc[-1] if acc else None,
            "best_accuracy": max(acc) if acc else None,
            "final_virtual_s": times[-1] if times else None,
            "times": times,
            "accuracy": acc,
        }
    return report


# ---------------------------------------------------------------------------
# text rendering
# ---------------------------------------------------------------------------

def _fmt(v, spec=".3f") -> str:
    return "-" if v is None else format(v, spec)


def format_report(report: Dict, source: str = "") -> str:
    lines = []
    head = f"== FL run report{f' ({source})' if source else ''} =="
    lines.append(head)
    lines.append(f"rounds={report['rounds']} "
                 f"population={report['population']} "
                 f"migrations={report['n_migrations']} "
                 f"stragglers: carried={report['stragglers']['carried']} "
                 f"dropped={report['stragglers']['dropped']}")
    cols = ["tier", "size", "selected", "particip", "timeouts", "hit_rate",
            "resp_s", "thr_s", "headroom", "stale_p95", "up_B/rnd",
            "up_MB"]
    rows = [cols]
    for t, r in sorted(report["tiers"].items()):
        rows.append([
            str(t), _fmt(r.get("size_last"), "d"),
            str(r["selected"]), str(r["participated"]),
            str(r["timeout_hits"]), _fmt(r["timeout_hit_rate"], ".2f"),
            _fmt(r.get("mean_response_s")), _fmt(r.get("mean_threshold_s")),
            _fmt(r.get("mean_response_frac"), ".2f"),
            _fmt(r.get("staleness_p95"), ".1f"),
            _fmt(r.get("uplink_bytes_per_round"), ".0f"),
            _fmt(r.get("uplink_mb"), ".3f"),
        ])
    widths = [max(len(row[i]) for row in rows) for i in range(len(cols))]
    for row in rows:
        lines.append("  ".join(c.rjust(w) for c, w in zip(row, widths)))
    if report["migration_matrix"]:
        pairs = ", ".join(f"{k}: {v}" for k, v in
                          sorted(report["migration_matrix"].items()))
        lines.append(f"migration matrix  {pairs}")
    up = report.get("uplink")
    if up:
        per_rnd = (f" ({up['bytes_per_round']:.0f} B/round)"
                   if up.get("bytes_per_round") else "")
        lines.append(f"uplink  {up['total_mb']:.3f} MB modeled"
                     f"{per_rnd}")
    sel = report["fairness"].get("selection")
    if sel:
        lines.append(f"selection fairness  gini={sel['gini']:.3f} "
                     f"coverage={sel['coverage']:.2f} "
                     f"min={sel['min']:.0f} max={sel['max']:.0f}")
    traj = report.get("trajectory")
    if traj and traj["evals"]:
        lines.append(f"trajectory  {traj['method']}: "
                     f"final acc={traj['final_accuracy']:.4f} "
                     f"(best {traj['best_accuracy']:.4f}) "
                     f"@ virtual {traj['final_virtual_s']:.1f}s "
                     f"over {traj['evals']} evals")
    if report["dropped_labels"]:
        lines.append(f"WARNING: {report['dropped_labels']} labeled "
                     f"records dropped at the cardinality cap")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Per-tier FL run report from a trace (jsonl/chrome) "
                    "or a saved RunHistory JSON.")
    ap.add_argument("path", help="trace file or RunHistory JSON")
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="also write the structured report as JSON here")
    args = ap.parse_args(argv)
    try:
        summary, history = load_source(args.path)
    except (OSError, json.JSONDecodeError) as e:
        print(f"report: cannot read {args.path}: {e}", file=sys.stderr)
        return 2
    if summary is None:
        print(f"report: no telemetry summary in {args.path} "
              f"(traced run required)", file=sys.stderr)
        return 2
    report = build_report(summary, history)
    print(format_report(report, source=args.path))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"report: json -> {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
