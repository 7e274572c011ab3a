"""repro_torch.obs — tracing + metrics, the port's copy of ``repro.obs``.

One process-global :class:`Tracer` (disabled by default: ``span()`` is
a true no-op) and one :class:`MetricsRegistry` shared by every
instrumented layer.  Module-level helpers delegate to the globals so
hot paths write ``obs.span("round.transfer")`` / ``obs.inc(...)``
without threading handles through every call signature.  Spans export
as a Chrome / Perfetto trace (``obs.export``), and a traced distributed
stream's rounds join against ``dist.overlap.round_time_model``
(``obs.calibrate``).

>>> from repro_torch import obs
>>> tracer = obs.configure(enabled=True)      # start tracing
>>> with obs.span("round", round=0):
...     pass
>>> obs.export_trace("trace.json")            # open in ui.perfetto.dev
"""

from __future__ import annotations

from typing import Any

from repro_torch.obs.calibrate import (PHASES, CalibrationReport,
                                       CalibrationRow, calibration_report,
                                       phase_durations)
from repro_torch.obs.export import (chrome_trace_events, export_trace,
                                    load_trace, validate_trace)
from repro_torch.obs.metrics import REGISTRY, MetricsRegistry
from repro_torch.obs.trace import NULL_SPAN, Span, Stopwatch, Tracer

__all__ = [
    "Tracer", "Span", "Stopwatch", "NULL_SPAN",
    "MetricsRegistry", "REGISTRY",
    "configure", "get_tracer", "set_tracer", "enabled",
    "span", "stopwatch", "add_span", "now_s", "span_summary",
    "metrics", "inc", "gauge", "metrics_snapshot",
    "chrome_trace_events", "export_trace", "load_trace", "validate_trace",
    "PHASES", "CalibrationRow", "CalibrationReport",
    "calibration_report", "phase_durations",
]

_tracer = Tracer(enabled=False)


def configure(enabled: bool = True, capacity: int = 65536,
              fence: bool = True, phases: bool = True) -> Tracer:
    """Install (and return) a fresh global tracer."""
    global _tracer
    _tracer = Tracer(enabled=enabled, capacity=capacity, fence=fence,
                     phases=phases)
    return _tracer


def get_tracer() -> Tracer:
    return _tracer


def set_tracer(tracer: Tracer) -> Tracer:
    global _tracer
    _tracer = tracer
    return tracer


def enabled() -> bool:
    return _tracer.enabled


def span(name: str, cat: str = "phase", **attrs: Any):
    """Pure span on the global tracer (no-op when disabled)."""
    # inlined fast path: the disabled branch must not repack **attrs
    # through Tracer.span — this helper sits inside hot loops
    t = _tracer
    if not t.enabled:
        return NULL_SPAN
    return Span(t, name, cat, attrs)


def stopwatch(name: str, cat: str = "phase", **attrs: Any) -> Stopwatch:
    """Always-measuring stopwatch on the global tracer."""
    return _tracer.stopwatch(name, cat=cat, **attrs)


def add_span(name: str, start_s: float, dur_s: float, cat: str = "derived",
             **attrs: Any) -> None:
    _tracer.add_span(name, start_s, dur_s, cat=cat, **attrs)


def now_s() -> float:
    """Seconds on the span clock (always available)."""
    return _tracer.now_s()


def span_summary(spans=None) -> dict[str, dict]:
    return _tracer.summary(spans)


def metrics() -> MetricsRegistry:
    return REGISTRY


def inc(name: str, value: float = 1) -> None:
    REGISTRY.inc(name, value)


def gauge(name: str, value: float) -> None:
    REGISTRY.gauge(name, value)


def metrics_snapshot() -> dict[str, Any]:
    return REGISTRY.snapshot()
