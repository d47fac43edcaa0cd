"""Telemetry stub: the no-op surface the sync and async paths call.

The reference's runtime telemetry (``repro/obs/telemetry.py``) and its
FL-semantic streams (``repro/obs/flstats.py``) are ported in a later
slice.  Until then the schedulers, the engine and the async runtime
call this stub, which records nothing and never reads a tensor back:
``TEL.span(..)`` as a context manager or with ``.start()`` /
``.end()``, ``TEL.inc``, ``TEL.gauge``, ``TEL.observe``,
``TEL.set_virtual_time``, ``TEL.summarize_into``, ``TEL.enabled``
(always ``False``, so guarded recording blocks are skipped) and
``flstats.record_*``.
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
    enabled = False

    def span(self, name, **args):
        return _SPAN

    def inc(self, name, value=1):
        return None

    def gauge(self, name, value):
        return None

    def observe(self, name, value):
        return None

    def set_virtual_time(self, t):
        return None

    def summarize_into(self, meta):
        return None


TEL = NoopTelemetry()


def _noop(*args, **kwargs):
    return None


flstats = SimpleNamespace(record_tiering=_noop, record_selection=_noop,
                          record_response=_noop, record_straggler=_noop,
                          record_staleness=_noop,
                          record_client_updates=_noop,
                          record_uplink=_noop, record_update_norm=_noop)
