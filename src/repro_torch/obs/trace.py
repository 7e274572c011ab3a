"""Thread-safe phase tracer: nested spans on one monotonic clock.

The port's copy of ``repro.obs.trace``.  The one change is the span
fence: where JAX blocked on arrays (``jax.block_until_ready``), the port
synchronises the CUDA device the fenced tensors live on.

Two primitives, with deliberately different disabled-path contracts:

* ``Tracer.span(name)`` — a *pure* span.  When the tracer is disabled it
  returns a shared null object and performs **zero clock reads**; hot
  loops can leave spans inline at no cost (the JAX package's
  ``benchmarks/obs_bench.py`` bounds its overhead; the port has no
  benchmark yet).
* ``Tracer.stopwatch(name)`` — an *always-on* measurement.  It reads the
  clock whether or not tracing is enabled (its ``.seconds`` feeds
  report fields such as ``ServeResult.ingest_seconds``) and additionally
  records a span when tracing is on.  Raw ``time.perf_counter()`` reads
  outside ``obs/`` are a dynlint violation.

Spans are stored in a bounded ring (``collections.deque(maxlen=…)``);
once full, the oldest spans are evicted and counted in
``Tracer.dropped``.  All timestamps come from ``time.perf_counter_ns``
relative to the tracer's epoch, so spans from every thread share one
clock.  CUDA work is asynchronous — with ``fence=True`` (the default
for an enabled tracer) a span exit calls ``torch.cuda.synchronize`` on
the device of whatever the span registered via ``Span.fence(obj)``, so
device phases measure *execution*, not dispatch.  Fencing serializes
the dispatch pipeline: a traced run measures a serial schedule (the
observer effect the calibration report accounts for by comparing against
``round_time_model``'s ``serial_s``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Iterator

__all__ = ["Span", "Stopwatch", "Tracer", "NULL_SPAN"]


def _fence(obj: Any) -> None:
    """Wait for the CUDA device holding the first tensor in ``obj``
    (a tensor or a nested tuple / list / dict of them)."""
    stack = [obj]
    while stack:
        o = stack.pop()
        if isinstance(o, dict):
            stack.extend(o.values())
        elif isinstance(o, (list, tuple)):
            stack.extend(o)
        elif getattr(o, "is_cuda", False):
            import torch
            torch.cuda.synchronize(o.device)
            return


class Span:
    """One timed region.  Use as a context manager; ``fence(obj)``
    registers tensors whose device to synchronise at exit (only honoured
    when the owning tracer fences)."""

    __slots__ = ("name", "cat", "tid", "thread_name", "start_s", "dur_s",
                 "attrs", "_fence_obj", "_tracer", "_t0_ns")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 attrs: dict[str, Any]):
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self.tid = threading.get_ident()
        self.thread_name = threading.current_thread().name
        self.start_s = 0.0
        self.dur_s = 0.0
        self._fence_obj: Any = None
        self._tracer = tracer
        self._t0_ns = 0

    def fence(self, obj: Any) -> Any:
        """Register ``obj`` (tensors, possibly nested) to synchronise on
        at span exit; returns ``obj`` so call sites can fence inline."""
        self._fence_obj = obj
        return obj

    def __enter__(self) -> "Span":
        self._t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        tr = self._tracer
        # the recorded span must not keep the fenced tensors alive
        obj, self._fence_obj = self._fence_obj, None
        if obj is not None and tr.fencing:
            _fence(obj)
        end_ns = time.perf_counter_ns()
        self.start_s = (self._t0_ns - tr._epoch_ns) * 1e-9
        self.dur_s = (end_ns - self._t0_ns) * 1e-9
        tr._record(self)

    # convenience for symmetric reading with Stopwatch
    @property
    def seconds(self) -> float:
        return self.dur_s


class _NullSpan:
    """Shared no-op span: the disabled-tracer fast path.  No clock
    reads, no allocation per use."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def fence(self, obj: Any) -> Any:
        return obj

    name = ""
    cat = ""
    start_s = 0.0
    dur_s = 0.0
    seconds = 0.0
    attrs: dict[str, Any] = {}


NULL_SPAN = _NullSpan()


class Stopwatch:
    """Always-times context manager.  ``.seconds`` is valid after exit
    regardless of tracer state; a span is recorded only when tracing."""

    __slots__ = ("name", "cat", "attrs", "seconds", "start_s", "_tracer",
                 "_t0_ns", "_fence_obj")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 attrs: dict[str, Any]):
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self.seconds = 0.0
        self.start_s = 0.0
        self._tracer = tracer
        self._t0_ns = 0
        self._fence_obj: Any = None

    def fence(self, obj: Any) -> Any:
        """Like ``Span.fence`` — only honoured when the tracer fences,
        so an untraced run keeps its async dispatch schedule."""
        self._fence_obj = obj
        return obj

    def __enter__(self) -> "Stopwatch":
        self._t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        tr = self._tracer
        obj, self._fence_obj = self._fence_obj, None
        if obj is not None and tr.enabled and tr.fencing:
            _fence(obj)
        end_ns = time.perf_counter_ns()
        self.start_s = (self._t0_ns - tr._epoch_ns) * 1e-9
        self.seconds = (end_ns - self._t0_ns) * 1e-9
        if tr.enabled:
            sp = Span(tr, self.name, self.cat, self.attrs)
            sp.start_s = self.start_s
            sp.dur_s = self.seconds
            tr._record(sp)


class Tracer:
    """Bounded-ring span recorder shared by every instrumented layer.

    ``enabled=False`` (the default) is a true no-op for ``span()``:
    one attribute read and the shared ``NULL_SPAN`` — nothing else.
    """

    def __init__(self, enabled: bool = False, capacity: int = 65536,
                 fence: bool = True, phases: bool = True):
        self.enabled = bool(enabled)
        self.fencing = bool(fence)
        # derive per-round spatial/a2a/temporal spans from the comp-ref
        # probe in the distributed trainer (see stream/distributed.py)
        self.phases = bool(phases)
        self.capacity = int(capacity)
        self.recorded = 0          # total spans ever recorded
        self._spans: deque[Span] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._epoch_ns = time.perf_counter_ns()

    # ------------------------------------------------------------ record

    def span(self, name: str, cat: str = "phase", **attrs: Any):
        """Pure span: no-op (no clock read) when disabled."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, cat, attrs)

    def stopwatch(self, name: str, cat: str = "phase",
                  **attrs: Any) -> Stopwatch:
        """Always-measuring stopwatch (span recorded only if enabled)."""
        return Stopwatch(self, name, cat, attrs)

    def add_span(self, name: str, start_s: float, dur_s: float,
                 cat: str = "derived", tid: int | None = None,
                 **attrs: Any) -> None:
        """Inject a span with explicit timing (derived phases, replayed
        measurements).  No-op when disabled."""
        if not self.enabled:
            return
        sp = Span(self, name, cat, attrs)
        sp.start_s = float(start_s)
        sp.dur_s = float(dur_s)
        if tid is not None:
            sp.tid = tid
        self._record(sp)

    def _record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
            self.recorded += 1

    # ------------------------------------------------------------- query

    def now_s(self) -> float:
        """Seconds since the tracer epoch — the span clock.  Use this
        (not raw perf_counter) for latency bookkeeping outside spans."""
        return (time.perf_counter_ns() - self._epoch_ns) * 1e-9

    def spans(self) -> list[Span]:
        """Snapshot of the ring (oldest first)."""
        with self._lock:
            return list(self._spans)

    def spans_since(self, recorded_before: int) -> list[Span]:
        """Spans recorded after a ``tracer.recorded`` checkpoint (up to
        ring capacity — older ones may have been evicted)."""
        with self._lock:
            n = min(self.recorded - recorded_before, len(self._spans))
            if n <= 0:
                return []
            return list(self._spans)[-n:]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.recorded = 0

    @property
    def dropped(self) -> int:
        """Spans evicted from the ring (recorded but no longer stored)."""
        with self._lock:
            return self.recorded - len(self._spans)

    def summary(self, spans: list[Span] | None = None) -> dict[str, dict]:
        """Per-name aggregate: count / total_s / mean_s / max_s."""
        out: dict[str, dict] = {}
        for sp in (self.spans() if spans is None else spans):
            agg = out.setdefault(sp.name, {"count": 0, "total_s": 0.0,
                                           "max_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += sp.dur_s
            agg["max_s"] = max(agg["max_s"], sp.dur_s)
        for agg in out.values():
            agg["mean_s"] = agg["total_s"] / agg["count"]
        return out

    def __iter__(self) -> Iterator[Span]:
        return iter(self.spans())
