"""The traced run (``--trace 1``): the program's spans and the profiler.

The program's telemetry (``repro_torch.obs``) records its spans for the
whole run: ``round.select``, ``round.train``, ``round.aggregate`` and
``eval`` in a sync round; ``window.gather``, ``window.train`` and
``window.merge_scatter`` in an async one; each with its host time and,
on the card, the device time between CUDA events at its ends.  The
metrics read the spans of the window's rounds.  ``torch.profiler``
records every device operation over the first ``profile_rounds`` whole
rounds of the window, and the metrics that need device intervals or
kernel times read those rounds only.  The profiler's events are read
after the run, outside the window.

``Trace`` is what a metric reader gets: ``read(trace) -> float | None``.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional

import torch

MARK = "flbench.mark"


class Trace:
    """What one traced run saw.

    * ``rounds``: the window's rounds, each ``{"calls": [...], "acc",
      "t"}`` (``bench.Recorder``), and ``spans``: the program's span
      records that started inside the window (``name``, ``t0`` and
      ``dur_s`` on the host clock, ``dev_s`` on the card or None,
      ``args``).
    * ``profiled``: the window's rounds under the profiler, as indices
      into ``rounds``; ``ops``: their device operations as ``(start_s,
      end_s, name)`` on the host clock; ``profile_span``: the host times
      at which the first began and the last ended; ``profiled_s``: its
      length.
    * ``config``, ``traffic``: the cell's files.
    """

    def __init__(self, cell: Dict):
        self.config = cell["config"]
        self.traffic = cell["traffic"]
        self.rounds: List[Dict] = []
        self.spans: List[Dict] = []
        self.profiled: List[int] = []
        self.ops: List[tuple] = []
        self.profile_span = (0.0, 0.0)
        self.profiled_s = 0.0

    def span_total(self, names, device: bool) -> Optional[float]:
        """Seconds in spans of these names (device or host), or None
        when none was recorded."""
        vals = [s["dev_s"] if device else s["dur_s"] for s in self.spans
                if s["name"] in names]
        if not vals or (device and any(v is None for v in vals)):
            return None
        return float(sum(vals))

    def per_round_ms(self, names, device: bool) -> Optional[float]:
        total = self.span_total(names, device)
        if total is None or not self.rounds:
            return None
        return total * 1e3 / len(self.rounds)

    def _clipped(self):
        a0, a1 = self.profile_span
        return sorted((max(a, a0), min(b, a1), n) for a, b, n in self.ops
                      if b > a0 and a < a1)

    def busy_s(self) -> float:
        """Seconds of the profiled rounds in which a device operation
        ran (the union of their intervals)."""
        busy, end = 0.0, float("-inf")
        for a, b, _ in self._clipped():
            if b <= end:
                continue
            busy += b - max(a, end)
            end = b
        return busy

    def idle_gaps(self) -> List[tuple]:
        """(start, end) of the device's idle intervals inside the
        profiled rounds."""
        if not self.profiled:
            return []
        end, t1 = self.profile_span
        gaps = []
        for a, b, _ in self._clipped():
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if end < t1:
            gaps.append((end, t1))
        return gaps


class Tracer:
    """Turns on the program's telemetry for the run and the profiler
    for the window's first ``profile_rounds`` rounds.

    The profiler records device activity only, whose timestamps are
    wall-clock nanoseconds; ``begin`` runs one short session with host
    activity too in the set-up, which brings up the profiler's device
    tracing (its first start takes seconds) and checks that clock
    against a mark."""

    def __init__(self, cell: Dict):
        self.cell = cell
        self.trace = Trace(cell)
        self.n_profile = cell["traffic"]["trace"]["profile_rounds"]
        self.prof = None
        self.rec = None
        self.first = self.last = None
        self.offset = 0.0

    def _activities(self):
        from torch.profiler import ProfilerActivity
        return ([ProfilerActivity.CUDA] if torch.cuda.is_initialized()
                else [ProfilerActivity.CPU])

    def begin(self, rec):
        from torch.profiler import ProfilerActivity, profile, record_function

        from repro_torch.obs import telemetry
        self.rec = rec
        with profile(activities=sorted({ProfilerActivity.CPU,
                                        *self._activities()},
                                       key=str)) as prof:
            with record_function(MARK):
                wall = time.time_ns()
        mark = [e.start_ns() for e in prof.profiler.kineto_results.events()
                if e.name() == MARK]
        if not mark or abs(mark[0] - wall) > 50_000_000:
            raise RuntimeError("the profiler's clock is not the wall clock")
        telemetry.enable()

    def on_window(self, event: str, rnd: int):
        from torch.profiler import profile
        if event == "start":
            self.offset = time.perf_counter() - time.time_ns() * 1e-9
            self.prof = profile(activities=self._activities())
            self.prof.__enter__()
            self.first = rnd + 1
        elif self.prof is not None and self.last is None and (
                event == "stop" or rnd - self.first + 1 >= self.n_profile):
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
            self.last = rnd

    def _read_profile(self):
        from torch.autograd import DeviceType
        off = self.offset
        self.trace.ops = [
            (e.start_ns() * 1e-9 + off, e.end_ns() * 1e-9 + off, e.name())
            for e in self.prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation()]

    def finish(self):
        from repro_torch.obs import telemetry
        if self.prof is not None and self.last is None:
            self.on_window("stop", len(self.rec.rounds))
        tel = telemetry.disable()
        tel.resolve()
        rec, tr = self.rec, self.trace
        if self.prof is not None:
            self._read_profile()
            self.prof = None
        warm = self.cell["traffic"]["warmup_rounds"]
        tr.rounds = rec.rounds[warm:]
        start = rec.t_start
        end = rec.t_end if rec.t_end is not None else float("inf")
        for s in tel.spans:
            t0 = tel.t0 + s["ts_us"] * 1e-6
            if start <= t0 <= end:
                tr.spans.append({
                    "name": s["name"], "t0": t0, "dur_s": s["dur_us"] * 1e-6,
                    "dev_s": None if s["dev_us"] is None
                    else s["dev_us"] * 1e-6, "args": s["args"]})
        if self.first is not None:
            tr.profiled = list(range(self.first - warm - 1,
                                     self.last - warm))
            tr.profile_span = (rec.rounds[self.first - 2]["t"],
                               rec.rounds[self.last - 1]["t"])
            tr.profiled_s = tr.profile_span[1] - tr.profile_span[0]


def breakdown(trace: Trace, top: int = 10) -> Dict:
    """The device operations that took most time, and the device's
    longest idle time by the program span the host was in."""
    by_op: Dict[str, float] = {}
    for a, b, name in trace.ops:
        by_op[name] = by_op.get(name, 0.0) + (b - a)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    spans = sorted(trace.spans, key=lambda s: s["t0"])
    starts = [s["t0"] for s in spans]
    idle: Dict[str, float] = {}
    for a, b in trace.idle_gaps():
        mid = 0.5 * (a + b)
        # spans nest a few deep, so the innermost open one is among the
        # last few that started before the gap's middle
        near = spans[max(bisect.bisect_right(starts, mid) - 32, 0):
                     bisect.bisect_right(starts, mid)]
        inner = [s for s in near if mid <= s["t0"] + s["dur_s"]]
        label = (min(inner, key=lambda s: s["dur_s"])["name"] if inner
                 else "outside the program's spans")
        idle[label] = idle.get(label, 0.0) + (b - a)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
