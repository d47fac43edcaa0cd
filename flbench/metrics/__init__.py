"""One reader a per-layer metric, found by the metric's name:
``read(trace) -> float | None`` (``flbench/trace.py: Trace``).  A reader
that finds nothing to read returns None, and the run leaves the metric
out of its line."""
