"""Runtime telemetry: span tracer + metrics registry.

FedDCT's claims are about *time* — where a round's wall-clock actually
goes (queue wait vs gather vs cohort train vs merge vs scatter vs
eviction) is the datum every perf PR needs and ``RunHistory`` cannot
carry.  This module is the zero-overhead-when-disabled core:

* ``TEL`` is the module-global active telemetry.  It defaults to the
  ``NOOP`` singleton, whose every method is a constant-return no-op —
  an instrumented call site (``obs.TEL.span(...)``) pays one module
  attribute lookup plus one trivial method call when tracing is off,
  and the no-op ``span`` hands back a shared null context manager (no
  allocation).  ``enable()`` swaps in a recording ``Telemetry``;
  ``disable()`` swaps ``NOOP`` back and returns the recording for
  export.
* ``Telemetry.span(name, **args)`` records BOTH clocks: host
  wall-clock (``perf_counter``) and the simulated virtual time the
  runners maintain via ``set_virtual_time`` — so a trace can show that
  a merge which took 2 ms of host time covered 40 virtual seconds of
  simulated network wait.
* counters / gauges / histograms (``inc`` / ``gauge`` / ``observe``)
  feed the end-of-run aggregate (``summary`` /
  ``summarize_into(hist.meta)`` — the ``meta["telemetry"]`` block).
* kernel builds are counted by ``repro_torch.kernels._build``: every
  ``nvcc`` run while tracing is on increments ``kernel.builds`` and
  observes ``kernel.build_s`` (the port's counterpart of a backend
  compile).

Clock caveat: CUDA launches are asynchronous, so a span's host time
measures the host-side enqueue plus whatever the wrapped code blocks
on; device time is absorbed by the next blocking point (``evaluate``,
a readback).  Spans attribute where the HOST spends its time.  So
that the device side is not guessed from it, a span that opens and
closes while CUDA is initialised also records a CUDA event on the
current stream at each end: ``dev_us`` is the stream's time from the
first event to the second — the device work the span enqueued plus
any wait between it and what came before.  Events are read only in
``summary()`` / export, after one ``torch.cuda.synchronize()``, so
tracing adds no host sync inside a round; a span recorded without a
CUDA device has ``dev_us = None``.

Exporters (JSONL event log, Chrome ``trace_event`` for
chrome://tracing / Perfetto) live in ``repro_torch.obs.export``.
"""

from __future__ import annotations

import contextlib
from time import perf_counter
from typing import Dict, List, Optional

import torch

SCHEMA_VERSION = 1

# hard caps so a runaway loop cannot swallow host memory; overflow is
# counted (``telemetry.dropped_*``), never silent
MAX_SPANS = 500_000
MAX_SERIES = 100_000
MAX_HIST = 500_000


class _NoopSpan:
    """Shared null span: context manager AND manual start/end, every
    method a no-op returning ``self`` so call sites never branch."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def start(self):
        return self

    def end(self):
        return self

    def set(self, **args):
        return self


_NOOP_SPAN = _NoopSpan()


class NoopTelemetry:
    """The disabled-mode singleton: every hook is a constant no-op."""

    __slots__ = ()
    enabled = False

    def span(self, name, **args):
        return _NOOP_SPAN

    def inc(self, name, n=1):
        pass

    def gauge(self, name, value):
        pass

    def observe(self, name, value):
        pass

    def set_virtual_time(self, t):
        pass

    def summarize_into(self, meta):
        pass


NOOP = NoopTelemetry()

# the active telemetry — instrumented modules read ``obs.TEL`` fresh on
# every use (one attribute lookup), so enable/disable swaps take effect
# everywhere at once
TEL = NOOP


def _device_event():
    """A timing event recorded now on the current CUDA stream, or None
    when CUDA is not initialised (a CPU run).  Never synchronises."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class Span:
    """One traced section: wall-clock + virtual-time interval with
    attached args, plus a device interval on the card.  Works as a
    context manager or via explicit ``start()`` / ``end()`` (for loops
    that cannot re-indent)."""

    __slots__ = ("_tel", "name", "args", "t0", "vt0", "ev0")

    def __init__(self, tel: "Telemetry", name: str, args: Dict):
        self._tel = tel
        self.name = name
        self.args = args
        self.t0 = 0.0
        self.vt0 = 0.0
        self.ev0 = None

    def set(self, **args):
        self.args.update(args)
        return self

    def start(self):
        self.ev0 = _device_event()
        self.t0 = perf_counter()
        self.vt0 = self._tel.vt
        return self

    def end(self):
        self._tel._record_span(self)
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.end()
        return False


class Telemetry:
    """Recording telemetry: spans + counters + gauges + histograms."""

    enabled = True

    def __init__(self):
        self.t0 = perf_counter()     # trace epoch (host clock origin)
        self.vt = 0.0                # current simulated virtual time
        self.spans: List[Dict] = []
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.gauge_series: Dict[str, List] = {}
        self.hists: Dict[str, List[float]] = {}
        # device values still on the card: (span record, start event,
        # end event) and (histogram list, index) of observed tensors
        self._pending_spans: List = []
        self._pending_obs: List = []

    # -- spans ----------------------------------------------------------
    def span(self, name: str, **args) -> Span:
        return Span(self, name, args)

    def _record_span(self, s: Span):
        if len(self.spans) >= MAX_SPANS:
            self.inc("telemetry.dropped_spans")
            return
        now = perf_counter()
        rec = {
            "name": s.name,
            "ts_us": (s.t0 - self.t0) * 1e6,
            "dur_us": (now - s.t0) * 1e6,
            "dev_us": None,
            "vt0": s.vt0,
            "vt1": self.vt,
            "args": s.args,
        }
        self.spans.append(rec)
        if s.ev0 is not None:
            self._pending_spans.append((rec, s.ev0, _device_event()))

    # -- virtual clock --------------------------------------------------
    def set_virtual_time(self, t: float):
        self.vt = float(t)

    # -- metrics --------------------------------------------------------
    def inc(self, name: str, n=1):
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value):
        value = float(value)
        self.gauges[name] = value
        series = self.gauge_series.setdefault(name, [])
        if len(series) < MAX_SERIES:
            series.append(((perf_counter() - self.t0) * 1e6, value))
        else:
            self.inc("telemetry.dropped_gauge_points")

    def observe(self, name: str, value):
        """Record one histogram value.  A tensor is kept as it is (no
        readback here) and turned into a float by ``resolve``."""
        vals = self.hists.setdefault(name, [])
        if len(vals) < MAX_HIST:
            if isinstance(value, torch.Tensor):
                self._pending_obs.append((vals, len(vals)))
                vals.append(value)
            else:
                vals.append(float(value))
        else:
            self.inc("telemetry.dropped_hist_points")

    # -- device values --------------------------------------------------
    def resolve(self):
        """Read back every device value recorded so far: span device
        times from their CUDA events (after one synchronize) and
        observed tensors (one copy).  Called by ``summary`` and the
        exporters, never inside a round."""
        if self._pending_spans:
            torch.cuda.synchronize()
            for rec, e0, e1 in self._pending_spans:
                rec["dev_us"] = e0.elapsed_time(e1) * 1e3
            self._pending_spans = []
        if self._pending_obs:
            vals = torch.stack([v[i].detach().float().reshape(())
                                for v, i in self._pending_obs]).cpu()
            for (v, i), x in zip(self._pending_obs, vals.tolist()):
                v[i] = float(x)
            self._pending_obs = []

    # -- aggregate summary ----------------------------------------------
    def summary(self) -> Dict:
        """End-of-run aggregate: per-span totals (host seconds, device
        seconds where CUDA events were recorded, virtual seconds),
        counters, last gauge values, histogram stats, and derived rates
        (prefetch hit rate, lookahead accuracy) when their counters
        exist."""
        self.resolve()
        spans: Dict[str, Dict] = {}
        for s in self.spans:
            agg = spans.setdefault(s["name"], {"count": 0, "total_s": 0.0,
                                               "total_vt": 0.0,
                                               "dev_total_s": None})
            agg["count"] += 1
            agg["total_s"] += s["dur_us"] / 1e6
            agg["total_vt"] += s["vt1"] - s["vt0"]
            if s["dev_us"] is not None:
                agg["dev_total_s"] = ((agg["dev_total_s"] or 0.0)
                                      + s["dev_us"] / 1e6)
        for agg in spans.values():
            agg["mean_s"] = agg["total_s"] / agg["count"]
        hists = {}
        for name, vals in self.hists.items():
            import numpy as np
            a = np.asarray(vals, np.float64)
            hists[name] = {"count": int(a.size), "mean": float(a.mean()),
                           "p50": float(np.percentile(a, 50)),
                           "p95": float(np.percentile(a, 95)),
                           "max": float(a.max())}
        out = {"wall_s": perf_counter() - self.t0,
               "spans": spans,
               "counters": dict(self.counters),
               "gauges": dict(self.gauges),
               "hists": hists}
        rates = {}
        c = self.counters
        hit = c.get("residency.demand_hit", 0)
        miss = c.get("residency.demand_promote", 0)
        if hit + miss:
            rates["prefetch_hit_rate"] = hit / (hit + miss)
        la_hit = c.get("lookahead.hit", 0)
        la_miss = c.get("lookahead.miss", 0)
        if la_hit + la_miss:
            rates["lookahead_accuracy"] = la_hit / (la_hit + la_miss)
        if rates:
            out["rates"] = rates
        return out

    def summarize_into(self, meta: Dict):
        """Fold the aggregate into a ``RunHistory.meta`` dict (the
        ``meta["telemetry"]`` block every traced run carries)."""
        meta["telemetry"] = self.summary()

    # -- export convenience (see repro_torch.obs.export) -----------------
    def export_jsonl(self, path: str) -> str:
        from repro_torch.obs.export import export_jsonl
        return export_jsonl(self, path)

    def export_chrome(self, path: str) -> str:
        from repro_torch.obs.export import export_chrome
        return export_chrome(self, path)


# -- enable / disable ----------------------------------------------------

def enable(tel: Optional[Telemetry] = None) -> Telemetry:
    """Install a recording telemetry as the process-wide ``TEL``."""
    global TEL
    TEL = tel if tel is not None else Telemetry()
    return TEL


def disable() -> "Telemetry | NoopTelemetry":
    """Swap ``NOOP`` back in; returns the telemetry that was active
    (export it, then drop it)."""
    global TEL
    t = TEL
    TEL = NOOP
    return t


@contextlib.contextmanager
def tracing(tel: Optional[Telemetry] = None):
    """``with tracing() as tel:`` — enable for the block, always
    restore ``NOOP`` after."""
    t = enable(tel)
    try:
        yield t
    finally:
        disable()
