"""Counter/gauge registry: one dotted namespace for the repo's counters.

The port's copy of ``repro.obs.metrics``.

One thread-safe registry keyed by a stable dotted namespace.  The port
feeds:

* ``serve.windows_advanced`` — windows closed by ``ServeEngine.advance``;
* ``serve.events_ingested`` — running total of ingested events (gauge);
* ``serve.queries`` / ``serve.query_rows`` — requests / rows scored;
* ``serve.tokens_generated`` — tokens of ``ServeEngine.generate`` waves;
* ``stream.resyncs`` — encoder pad overflows -> full-frame resync;
* ``partition.a2a_calls`` / ``partition.a2a_bytes`` /
  ``partition.a2a_remote_bytes`` — the snapshot-partitioned schedule's
  all-to-alls (forward, recompute and backward), the bytes a rank hands
  to them and the (P - 1) / P of those that leave it;
* ``sanitize.guard_trips`` — ThreadAffinityGuard rejections.

Counters are monotonic within a process; use ``snapshot()`` +
``delta(before)`` to scope them to one run (that is how
``ServeResult.metrics`` is produced).
"""

from __future__ import annotations

import threading
from typing import Any

__all__ = ["MetricsRegistry", "REGISTRY"]


class MetricsRegistry:
    """Thread-safe counters (monotonic adds) + gauges (last value)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}

    # ------------------------------------------------------------ write

    def inc(self, name: str, value: float = 1) -> None:
        """Add ``value`` to counter ``name`` (created at 0)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def gauge(self, name: str, value: float) -> None:
        """Set gauge ``name`` to its latest ``value``."""
        with self._lock:
            self._gauges[name] = value

    # ------------------------------------------------------------- read

    def snapshot(self) -> dict[str, Any]:
        """Deep copy: ``{"counters": {...}, "gauges": {...}}``."""
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges)}

    def delta(self, before: dict[str, Any]) -> dict[str, Any]:
        """Counters since a ``snapshot()`` (zero-delta keys omitted);
        gauges are last-value, not differenced."""
        now = self.snapshot()
        base = before.get("counters", {})
        counters = {k: v - base.get(k, 0)
                    for k, v in now["counters"].items()
                    if v != base.get(k, 0)}
        return {"counters": counters, "gauges": now["gauges"]}

#: Process-global registry — the one namespace every subsystem feeds.
REGISTRY = MetricsRegistry()
