"""Unified observability: span tracing + metrics from scheduler to kernel.

``obs.trace`` is the span layer (Chrome-trace-event export, Perfetto
loadable); ``obs.metrics`` the counter/gauge/histogram registry riding on
each tracer; ``obs.logbuf`` the ring-buffer cap for the engine's
otherwise-unbounded decision logs; ``obs.validate`` the schema validator
``scripts/check_trace.py`` and the tier-1 tests share.

Everything is off by default behind a null object whose methods are
no-ops — the serve hot loop pays one attribute load and a falsy branch
when tracing is disabled (DESIGN.md section 16).
"""
from repro_torch.obs.logbuf import BoundedLog
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import (NULL, Tracer, current, resolve, set_current,
                             span_times, use)
from repro_torch.obs.validate import validate_chrome_trace

__all__ = ["BoundedLog", "MetricsRegistry", "NULL", "Tracer", "current",
           "resolve", "set_current", "span_times", "use",
           "validate_chrome_trace"]
