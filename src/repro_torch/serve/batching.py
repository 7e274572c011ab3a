"""Request micro-batching over static padded batch shapes.

The port's copy of ``repro.serve.batching``.  Live query traffic arrives
in ragged sizes; the query steps run on a few static shapes.  :class:`QueryBatcher` bridges the two:

* requests land on a BOUNDED queue (``queue_depth`` — backpressure: a
  submit into a full queue flushes the batch first, so pending work can
  never grow without limit);
* ``flush()`` drains the queue, concatenates the rows, and runs them in
  chunks padded up to the smallest configured bucket that fits (largest
  bucket per chunk) — a handful of query shapes, whatever the traffic;
* per-request latency is measured submit -> scores-on-host and recorded
  for the session's :class:`~repro_torch.serve.config.ServeResult`.

The run function owns the actual compute: it receives one padded
``(bucket, ...)`` array and must return host scores for those rows
(blocking until ready — the latency numbers are honest).
"""

from __future__ import annotations

import queue
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from repro_torch import obs


@dataclass
class PendingQuery:
    """One submitted request: ``rows`` in, ``scores`` out after a flush."""
    rows: np.ndarray
    submitted_at: float
    scores: np.ndarray | None = None

    @property
    def done(self) -> bool:
        return self.scores is not None


@dataclass
class BatcherStats:
    queries: int = 0          # individual requests
    rows: int = 0             # total rows scored (pre-padding)
    batches: int = 0          # padded device batches launched
    seconds: float = 0.0      # wall time inside flush()
    latencies_ms: list[float] = field(default_factory=list)


class QueryBatcher:
    """Bounded-queue micro-batcher in front of one padded query step."""

    def __init__(self, run_fn: Callable[[np.ndarray], np.ndarray],
                 batch_sizes: tuple[int, ...], queue_depth: int):
        if not batch_sizes or list(batch_sizes) != sorted(batch_sizes):
            raise ValueError(f"batch_sizes must be ascending and "
                             f"non-empty, got {batch_sizes}")
        self.run_fn = run_fn
        self.buckets = tuple(int(b) for b in batch_sizes)
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self.stats = BatcherStats()

    def bucket_for(self, n: int) -> int:
        """Smallest configured bucket >= n (chunking caps n at max)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def submit(self, rows) -> PendingQuery:
        """Enqueue one request; flushes first if the queue is full."""
        rows = np.asarray(rows)
        if rows.shape[0] == 0:
            raise ValueError("empty query")
        # span-clock timestamp: latency shares the tracer's clock, so
        # submit -> flush waits line up with spans in an exported trace
        p = PendingQuery(rows=rows, submitted_at=obs.now_s())
        try:
            self._q.put_nowait(p)
        except queue.Full:
            self.flush()
            self._q.put_nowait(p)
        return p

    def _drain(self) -> list[PendingQuery]:
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out

    def flush(self) -> list[PendingQuery]:
        """Score everything queued; returns the completed requests."""
        pending = self._drain()
        if not pending:
            return []
        with obs.stopwatch("serve.query.flush", cat="serve",
                           queries=len(pending)) as sw:
            rows = np.concatenate([p.rows for p in pending], axis=0)
            cap = self.buckets[-1]
            chunks = []
            for lo in range(0, rows.shape[0], cap):
                chunk = rows[lo:lo + cap]
                b = self.bucket_for(chunk.shape[0])
                padded = np.zeros((b,) + chunk.shape[1:], dtype=chunk.dtype)
                padded[:chunk.shape[0]] = chunk
                chunks.append(
                    np.asarray(self.run_fn(padded))[:chunk.shape[0]])
                self.stats.batches += 1
            scores = np.concatenate(chunks, axis=0)
        done = sw.start_s + sw.seconds       # flush end, on the span clock
        off = 0
        for p in pending:
            n = p.rows.shape[0]
            p.scores = scores[off:off + n]
            off += n
            self.stats.latencies_ms.append((done - p.submitted_at) * 1e3)
        self.stats.queries += len(pending)
        self.stats.rows += rows.shape[0]
        self.stats.seconds += sw.seconds
        obs.inc("serve.queries", len(pending))
        obs.inc("serve.query_rows", int(rows.shape[0]))
        return pending

    def query(self, rows) -> np.ndarray:
        """Synchronous convenience: submit + flush -> this request's
        scores (anything else queued rides along in the same flush)."""
        p = self.submit(rows)
        self.flush()
        return p.scores
