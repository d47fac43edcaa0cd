"""Validate an exported telemetry trace against its schema.

    PYTHONPATH=src python -m repro_torch.obs.validate trace.jsonl
    PYTHONPATH=src python -m repro_torch.obs.validate --format chrome trace.json

``--format`` is ``jsonl`` (line-delimited event log), ``chrome``
(trace_event JSON as written by ``export_chrome``), or ``auto`` (the
default: a file whose first byte opens a JSON object containing
``traceEvents`` is chrome, else JSONL).  Exit 0 when the file is a
well-formed trace; exit 2 with diagnostics otherwise.  CI runs this on
BOTH formats of the traced ``fl_train`` smoke before uploading the
trace artifacts.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Tuple

from repro_torch.obs.export import JSONL_TYPES
from repro_torch.obs.telemetry import SCHEMA_VERSION

REQUIRED = {
    "meta": ("schema_version", "clock"),
    "span": ("name", "ts_us", "dur_us", "vt0", "vt1", "args"),
    "counter": ("name", "value"),
    "gauge": ("name", "last", "series"),
    "hist": ("name", "count", "mean", "p50", "p95", "max"),
    "summary": ("wall_s", "spans", "counters"),
}


def validate_lines(lines) -> Tuple[List[str], dict]:
    """-> (errors, counts-by-type); empty errors == valid trace."""
    errors: List[str] = []
    counts = {t: 0 for t in JSONL_TYPES}
    for i, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            errors.append(f"line {i}: not JSON ({e})")
            continue
        t = rec.get("type")
        if t not in JSONL_TYPES:
            errors.append(f"line {i}: unknown record type {t!r}")
            continue
        counts[t] += 1
        missing = [k for k in REQUIRED[t] if k not in rec]
        if missing:
            errors.append(f"line {i}: {t} record missing {missing}")
        if t == "meta":
            if i != 1:
                errors.append(f"line {i}: meta header must be line 1")
            elif rec.get("schema_version") != SCHEMA_VERSION:
                errors.append(
                    f"line 1: schema_version "
                    f"{rec.get('schema_version')!r} != {SCHEMA_VERSION}")
    if counts["meta"] != 1:
        errors.append(f"expected exactly 1 meta header, got "
                      f"{counts['meta']}")
    if counts["summary"] != 1:
        errors.append(f"expected exactly 1 summary record, got "
                      f"{counts['summary']}")
    if counts["span"] == 0:
        errors.append("trace contains no spans")
    return errors, counts


def validate_file(path: str) -> Tuple[List[str], dict]:
    with open(path) as f:
        return validate_lines(f)


# ---------------------------------------------------------------------------
# chrome trace_event format (export_chrome)
# ---------------------------------------------------------------------------

# required keys per chrome event phase we emit ("M" metadata, "X"
# complete span, "C" counter track)
CHROME_PHASES = {
    "M": ("name", "pid", "tid", "args"),
    "X": ("name", "ph", "pid", "tid", "ts", "dur", "args"),
    "C": ("name", "ph", "pid", "tid", "ts", "args"),
}


def validate_chrome(doc) -> Tuple[List[str], dict]:
    """-> (errors, counts-by-phase); empty errors == valid trace."""
    errors: List[str] = []
    counts = {ph: 0 for ph in CHROME_PHASES}
    if not isinstance(doc, dict):
        return [f"top level must be a JSON object, got "
                f"{type(doc).__name__}"], counts
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        errors.append("missing traceEvents list")
        events = []
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph", "M")
        if ph not in CHROME_PHASES:
            errors.append(f"event {i}: unknown phase {ev.get('ph')!r}")
            continue
        counts[ph] += 1
        missing = [k for k in CHROME_PHASES[ph] if k not in ev]
        if missing:
            errors.append(f"event {i}: {ph} event missing {missing}")
            continue
        if ph == "X":
            args = ev["args"]
            if not isinstance(args, dict) \
                    or "vt0" not in args or "vt1" not in args:
                errors.append(f"event {i}: X event args must carry the "
                              f"virtual-time interval (vt0/vt1)")
    other = doc.get("otherData")
    if not isinstance(other, dict):
        errors.append("missing otherData object")
    else:
        if other.get("schema_version") != SCHEMA_VERSION:
            errors.append(f"otherData.schema_version "
                          f"{other.get('schema_version')!r} "
                          f"!= {SCHEMA_VERSION}")
        if not isinstance(other.get("counters"), dict):
            errors.append("otherData.counters must be an object")
        summary = other.get("summary")
        if not isinstance(summary, dict):
            errors.append("missing otherData.summary object")
        else:
            missing = [k for k in REQUIRED["summary"] if k not in summary]
            if missing:
                errors.append(f"otherData.summary missing {missing}")
    if counts["X"] == 0:
        errors.append("trace contains no spans (X events)")
    return errors, counts


def validate_chrome_file(path: str) -> Tuple[List[str], dict]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except json.JSONDecodeError as e:
        return [f"not a JSON document ({e})"], {}
    return validate_chrome(doc)


def sniff_format(path: str) -> str:
    """"chrome" when the file is one JSON object with ``traceEvents``,
    else "jsonl"."""
    with open(path) as f:
        head = f.read(4096)
    if head.lstrip().startswith("{"):
        try:
            first = json.loads(head.splitlines()[0])
            if isinstance(first, dict) and first.get("type") in JSONL_TYPES:
                return "jsonl"
        except json.JSONDecodeError:
            pass
        return "chrome"
    return "jsonl"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.validate",
        description="Validate an exported telemetry trace (JSONL event "
                    "log or Chrome trace_event JSON).")
    ap.add_argument("path", help="trace file to validate")
    ap.add_argument("--format", default="auto",
                    choices=["auto", "jsonl", "chrome"],
                    help="trace format (auto = sniff: a JSON object "
                         "with traceEvents is chrome, else jsonl)")
    args = ap.parse_args(argv)
    fmt = args.format
    try:
        if fmt == "auto":
            fmt = sniff_format(args.path)
        if fmt == "chrome":
            errors, counts = validate_chrome_file(args.path)
        else:
            errors, counts = validate_file(args.path)
    except OSError as e:
        print(f"[validate] cannot read {args.path}: {e}", file=sys.stderr)
        return 2
    if errors:
        for e in errors:
            print(f"[validate] {e}", file=sys.stderr)
        print(f"[validate] {args.path} ({fmt}): INVALID "
              f"({len(errors)} error(s))", file=sys.stderr)
        return 2
    print(f"[validate] {args.path} ({fmt}): OK  "
          + "  ".join(f"{t}={n}" for t, n in counts.items() if n))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
