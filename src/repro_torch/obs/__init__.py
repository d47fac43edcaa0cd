"""Telemetry stub: the no-op surface the sync slice calls.

The reference's runtime telemetry (``repro/obs/telemetry.py``) and its
FL-semantic streams (``repro/obs/flstats.py``) are ported in a later
slice.  Until then the schedulers and the engine call this stub, which
records nothing: ``TEL.span(..)`` as a context manager or with
``.start()`` / ``.end()``, ``TEL.inc``, ``TEL.set_virtual_time``,
``TEL.summarize_into`` and ``flstats.record_*``.
"""

from __future__ import annotations

from types import SimpleNamespace


class _NoopSpan:
    def start(self):
        return self

    def end(self):
        return None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_SPAN = _NoopSpan()


class NoopTelemetry:
    def span(self, name, **args):
        return _SPAN

    def inc(self, name, value=1):
        return None

    def set_virtual_time(self, t):
        return None

    def summarize_into(self, meta):
        return None


TEL = NoopTelemetry()


def _noop(*args, **kwargs):
    return None


flstats = SimpleNamespace(record_tiering=_noop, record_selection=_noop,
                          record_response=_noop, record_straggler=_noop)
