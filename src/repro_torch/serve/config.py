"""Serve configuration: the one declarative description of a serving run.

The port's copy of ``repro.serve.config``, for the dyngnn, lm and recsys
families.  The config separates

* the MODEL — an arch id from the registry (``arch="paper_dyngnn"``,
  ``"yi-6b"``, ``"din"``) and/or an explicit config object (``model=``,
  which wins; a :class:`repro_torch.core.models.DynGNNConfig`, a
  :class:`repro_torch.models.lm.LMConfig` or a
  :class:`repro_torch.models.din.DINConfig`);
* the INGEST discretization (:class:`IngestSpec`) — how the
  live CTDG event stream bins into time windows and how the delta
  encoder pads its payloads;
* the QUERY path — static padded micro-batch buckets and the bounded
  request queue;
* the lm GENERATE wave — prompt length and tokens generated per request.

``ServeEngine`` answers queries against resident temporal state;
``ServeResult`` carries the latency / throughput / ingest counters.
The JAX package's ``docs/serve_api.md`` describes the same surface.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from repro_torch.core.ctdg import (POLICIES, interaction_window_index,
                             snapshot_window_index, uniform_bounds)


@dataclass(frozen=True)
class IngestSpec:
    """How a live CTDG event stream discretizes into serve windows.

    * ``policy`` — ``"snapshot"`` (alive-edge view, ``snapshot_events``
      semantics) or ``"window"`` (interaction view, ``window_events``
      semantics); the online binning uses the exact offline formulas so
      a served stream discretizes onto the same windows the offline
      bridge would produce.
    * window geometry — either ``time_range=(t0, t1)`` split uniformly
      into ``num_windows`` (the offline-equivalent mode; the window
      policy requires it), or an open-ended ``window_span`` starting at
      ``t_start`` (live mode: window k covers
      ``(t_start + k*span, t_start + (k+1)*span]``).
    * ``block_size`` — full-snapshot resync cadence of the delta
      encoder (every ``block_size``-th window ships full — the online
      analogue of the offline checkpoint-block boundary rule);
    * ``max_edges`` — device edge-buffer capacity (serving must bound
      memory up front: a window whose graph exceeds it fails loudly);
    * ``churn_pad`` — drop/add delta pad size (None = ``max_edges``,
      always safe; size it from measured churn stats to shrink the
      per-window ingest payload).  Overflowing churn degrades to a
      FullSnapshot resync, counted on the report.
    """

    num_windows: int = 0                    # 0 = open-ended (span mode)
    policy: str = "snapshot"
    time_range: tuple[float, float] | None = None
    window_span: float | None = None
    t_start: float = 0.0
    block_size: int = 8
    max_edges: int = 4096
    churn_pad: int | None = None

    def validate(self) -> None:
        if self.policy not in POLICIES:
            raise ValueError(f"ingest.policy must be one of {POLICIES}, "
                             f"got {self.policy!r}")
        if (self.time_range is None) == (self.window_span is None):
            raise ValueError(
                "IngestSpec needs exactly one window geometry: either "
                "time_range=(t0, t1) with num_windows, or an open-ended "
                "window_span")
        if self.time_range is not None:
            t0, t1 = self.time_range
            if not (np.isfinite(t0) and np.isfinite(t1)) or t1 <= t0:
                raise ValueError(f"ingest.time_range must be a finite "
                                 f"(t0, t1) with t1 > t0, got "
                                 f"{self.time_range}")
            if self.num_windows < 1:
                raise ValueError("ingest.num_windows must be >= 1 when "
                                 "time_range is set")
        else:
            if self.window_span <= 0:
                raise ValueError(f"ingest.window_span must be positive, "
                                 f"got {self.window_span}")
            if self.policy == "window":
                raise ValueError(
                    "ingest.policy='window' bins with the offline "
                    "interaction formula, which needs the full "
                    "time_range — open-ended window_span only supports "
                    "policy='snapshot'")
        if self.block_size < 1:
            raise ValueError("ingest.block_size must be >= 1")
        if self.max_edges < 1:
            raise ValueError("ingest.max_edges must be >= 1")
        if self.churn_pad is not None and not (
                1 <= self.churn_pad <= self.max_edges):
            raise ValueError(f"ingest.churn_pad must be in "
                             f"[1, max_edges={self.max_edges}], got "
                             f"{self.churn_pad}")

    @property
    def drop_add_pad(self) -> int:
        return self.churn_pad if self.churn_pad is not None \
            else self.max_edges

    def bound(self, k: int) -> float:
        """End time of window k."""
        if self.time_range is not None:
            t0, t1 = self.time_range
            return float(uniform_bounds(t0, t1, self.num_windows)[k])
        return self.t_start + (k + 1) * self.window_span

    def window_of(self, time: np.ndarray) -> np.ndarray:
        """Window index owning each event time (policy-exact binning)."""
        time = np.asarray(time)
        if self.time_range is not None:
            t0, t1 = self.time_range
            if self.policy == "window":
                return interaction_window_index(time, t0, t1,
                                                self.num_windows)
            bounds = uniform_bounds(t0, t1, self.num_windows)
            return snapshot_window_index(time, bounds)
        idx = np.ceil((time - self.t_start) / self.window_span) - 1
        return np.maximum(idx, 0).astype(np.int64)


@dataclass(frozen=True)
class ServeConfig:
    """Declarative serving spec (see module docstring).

    ``batch_sizes`` are the STATIC padded query-batch shapes: every
    micro-batch pads up to the smallest bucket that fits, so live
    traffic runs a handful of query shapes.  ``queue_depth`` bounds the
    pending-request queue (backpressure: a submit into a full queue
    flushes first).  ``seed`` drives param init when no trained state is
    supplied, and the synthetic requests of the lm/recsys families.
    """

    arch: str | None = None
    model: Any = None                       # explicit config object (wins)
    ingest: IngestSpec | None = None        # dyngnn family only
    batch_sizes: tuple[int, ...] = (1, 8, 64)
    queue_depth: int = 64
    seed: int = 0
    # lm-family knobs (prefill + greedy decode)
    prompt_len: int = 32
    max_tokens: int = 64

    def validate(self) -> None:
        if self.arch is None and self.model is None:
            raise ValueError("ServeConfig needs an arch id or an explicit "
                             "model config")
        if not self.batch_sizes or any(b < 1 for b in self.batch_sizes):
            raise ValueError(f"ServeConfig.batch_sizes must be positive, "
                             f"got {self.batch_sizes}")
        if tuple(sorted(self.batch_sizes)) != tuple(self.batch_sizes):
            raise ValueError(f"ServeConfig.batch_sizes must be ascending, "
                             f"got {self.batch_sizes}")
        if self.queue_depth < 1:
            raise ValueError("ServeConfig.queue_depth must be >= 1")
        if self.prompt_len < 1 or self.max_tokens < 1:
            raise ValueError("ServeConfig.prompt_len/max_tokens must be "
                             ">= 1")
        if self.ingest is not None:
            self.ingest.validate()


@dataclass
class ServeResult:
    """Counters of a serving session (returned by ``ServeEngine.result()``).

    Latency percentiles are per REQUEST (submit -> scores on host),
    including queueing and micro-batch padding; ``events_per_s`` counts
    ingested events over the wall time spent in ingest + state advance.
    """

    family: str
    arch: str | None = None
    events_ingested: int = 0
    windows_advanced: int = 0
    resyncs: int = 0                        # delta-pad overflow resyncs
    queries: int = 0
    query_batches: int = 0
    tokens_generated: int = 0               # lm family
    guard_trips: int = 0                    # rejected concurrent entries
    ingest_seconds: float = 0.0
    query_seconds: float = 0.0
    query_latencies_ms: list[float] = field(default_factory=list)
    # repro_torch.obs registry delta scoped to this session + per-name
    # span summary
    metrics: dict | None = None

    def latency_ms(self, pct: float) -> float:
        if not self.query_latencies_ms:
            return float("nan")
        return float(np.percentile(self.query_latencies_ms, pct))

    @property
    def p50_ms(self) -> float:
        return self.latency_ms(50)

    @property
    def p95_ms(self) -> float:
        return self.latency_ms(95)

    @property
    def events_per_s(self) -> float:
        if self.ingest_seconds <= 0:
            return float("nan")
        return self.events_ingested / self.ingest_seconds

    def summary(self) -> str:
        """One line of the session's counters (the reference's)."""
        parts = [f"family={self.family}"]
        if self.arch:
            parts.append(f"arch={self.arch}")
        if self.events_ingested:
            parts.append(f"ingested {self.events_ingested} events over "
                         f"{self.windows_advanced} windows "
                         f"({self.events_per_s:.0f} ev/s, "
                         f"{self.resyncs} resyncs)")
        if self.queries:
            parts.append(f"{self.queries} queries in "
                         f"{self.query_batches} batches "
                         f"(p50 {self.p50_ms:.2f} ms, "
                         f"p95 {self.p95_ms:.2f} ms)")
        if self.tokens_generated:
            parts.append(f"{self.tokens_generated} tokens")
        if self.guard_trips:
            parts.append(f"{self.guard_trips} concurrent entries rejected")
        return "; ".join(parts)
