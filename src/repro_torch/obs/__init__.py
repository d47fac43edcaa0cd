"""Runtime telemetry layer: spans, counters, structured trace export.

Instrumented modules import the submodule and read the active
telemetry fresh on every use (zero-overhead-when-disabled contract —
one attribute lookup on the no-op singleton):

    from repro_torch.obs import telemetry as obs
    with obs.TEL.span("window.gather", rows=n):
        ...
    obs.TEL.inc("residency.demand_promote", k)

Users enable tracing around a run and export afterwards:

    from repro_torch import obs
    with obs.tracing() as tel:
        hist = run_method(...)          # meta["telemetry"] is folded in
    tel.export_chrome("trace.json")     # chrome://tracing / Perfetto
    tel.export_jsonl("trace.jsonl")     # repro_torch.obs.validate checks

or from the CLI: ``fl_train.py --trace PATH [--trace-format
jsonl|chrome]``.

FL-semantic labeled streams (per-tier / per-client diagnostics) live in
``repro_torch.obs.flstats``; ``repro_torch.obs.report`` folds a trace or a
``RunHistory`` JSON into the paper-Table-2-style per-tier report
(``python -m repro_torch.obs.report``).  On a CUDA device every span
also carries its device time (``dev_us``, from CUDA events read back
only at summary/export time).
"""

from repro_torch.obs.telemetry import (NOOP, SCHEMA_VERSION,
                                       NoopTelemetry, Telemetry, disable,
                                       enable, tracing)

__all__ = ["NOOP", "SCHEMA_VERSION", "NoopTelemetry", "Telemetry",
           "disable", "enable", "tracing"]
