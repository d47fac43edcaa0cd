"""Structured trace exporters: JSONL event log + Chrome trace_event.

* ``export_jsonl`` writes one JSON object per line — a ``meta`` header
  (schema version, clock convention, torch/device context) followed by every
  span, counter, gauge series, histogram summary, and the end-of-run
  aggregate.  ``repro_torch.obs.validate`` checks this schema (CI gates the
  traced ``fl_train`` smoke on it).
* ``export_chrome`` writes the Chrome ``trace_event`` JSON format:
  open it at chrome://tracing or https://ui.perfetto.dev.  Spans are
  complete ("X") events on one pid/tid (the runtime is single-
  threaded); each span carries its virtual-time interval in ``args``;
  gauge series (queue depth, …) become counter ("C") tracks.

A span's device time (``dev_us``, CUDA events; ``None`` on the CPU)
is a key of its JSONL record and of its Chrome event's ``args``; both
exporters read the device values back first (``Telemetry.resolve``).

Timestamps are microseconds since the telemetry's ``perf_counter``
epoch — relative host wall-clock, not civil time.
"""

from __future__ import annotations

import json
import os
from typing import Dict

from repro_torch.obs.telemetry import SCHEMA_VERSION, Telemetry

JSONL_TYPES = ("meta", "span", "counter", "gauge", "hist", "summary")


def _meta_header(tel: Telemetry) -> Dict:
    import torch
    ctx = {"type": "meta", "schema_version": SCHEMA_VERSION,
           "clock": "perf_counter_us", "virtual_clock": "seconds",
           "torch": torch.__version__}
    if torch.cuda.is_initialized():
        ctx["backend"] = "cuda"
        ctx["device_count"] = torch.cuda.device_count()
        ctx["device_name"] = torch.cuda.get_device_name()
    else:
        ctx["backend"] = "cpu"
        ctx["device_count"] = 1
    return ctx


def export_jsonl(tel: Telemetry, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    summary = tel.summary()       # resolves the device values first
    with open(path, "w") as f:
        f.write(json.dumps(_meta_header(tel)) + "\n")
        for s in tel.spans:
            f.write(json.dumps({"type": "span", **s}) + "\n")
        for name, value in sorted(tel.counters.items()):
            f.write(json.dumps({"type": "counter", "name": name,
                                "value": value}) + "\n")
        for name, series in sorted(tel.gauge_series.items()):
            f.write(json.dumps({"type": "gauge", "name": name,
                                "last": tel.gauges[name],
                                "series": series}) + "\n")
        for name, stats in sorted(summary["hists"].items()):
            f.write(json.dumps({"type": "hist", "name": name,
                                **stats}) + "\n")
        f.write(json.dumps({"type": "summary", **summary}) + "\n")
    return path


def export_chrome(tel: Telemetry, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    summary = tel.summary()       # resolves the device values first
    events = [
        {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
         "args": {"name": "repro_torch telemetry"}},
        {"name": "thread_name", "ph": "M", "pid": 0, "tid": 0,
         "args": {"name": "runtime"}},
    ]
    for s in tel.spans:
        events.append({
            "name": s["name"], "cat": s["name"].split(".")[0],
            "ph": "X", "pid": 0, "tid": 0,
            "ts": s["ts_us"], "dur": s["dur_us"],
            "args": {**s["args"], "vt0": s["vt0"], "vt1": s["vt1"],
                     "dev_us": s["dev_us"]},
        })
    for name, series in sorted(tel.gauge_series.items()):
        for ts, value in series:
            events.append({"name": name, "ph": "C", "pid": 0, "tid": 0,
                           "ts": ts, "args": {name: value}})
    payload = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"schema_version": SCHEMA_VERSION,
                      "counters": tel.counters,
                      "summary": summary},
    }
    with open(path, "w") as f:
        json.dump(payload, f)
    return path
