"""Live CTDG ingest: event pushes -> per-window delta-stream items.

The port's copy of ``repro.serve.ingest`` (host numpy; its items are held
byte-identical to the reference's by ``tests/test_torch_stream.py``).
The online half of the ``core.ctdg`` bridge.  Offline, the whole event
trace exists up front and ``snapshot_events`` / ``window_events``
materialize every snapshot at once; online, events arrive in pushes and
windows close one at a time.  :class:`OnlineIngester` therefore runs the
SAME primitives incrementally:

* window binning via ``IngestSpec.window_of`` — the exact offline
  formulas (``snapshot_window_index`` / ``interaction_window_index``),
  so a live stream discretizes onto the windows the offline bridge
  would produce;
* alive-edge bookkeeping via :class:`~repro_torch.core.ctdg.AliveSet` — the
  same insertion-ordered structure, applied window by window (window
  index is monotone in sorted time, so per-window application preserves
  the offline global order and the snapshots are byte-identical);
* delta encoding via :class:`~repro_torch.stream.encoder.IncrementalEncoder`
  — the same encoder the JAX package's offline ``iter_encode_stream``
  loops over.

Nothing is ever materialized for the full trace: the ingester holds the
not-yet-closed event buffer, the alive set, and the encoder's device
mirror — O(current graph + open-window events), independent of stream
length.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.ctdg import AliveSet, EventStream
from repro_torch.core.graphdiff import FullSnapshot, SnapshotDelta
from repro_torch.graph import generate
from repro_torch.serve.config import IngestSpec
from repro_torch.stream.encoder import IncrementalEncoder, StreamReport


class LateEventError(ValueError):
    """A pushed event belongs to an already-closed window."""

    def __init__(self, time: float, window: int, next_window: int):
        self.time, self.window, self.next_window = time, window, next_window
        super().__init__(
            f"event at t={time} belongs to window {window}, which already "
            f"closed (next open window is {next_window}); late events "
            "cannot be applied retroactively — widen the windows or "
            "buffer upstream")


class OnlineIngester:
    """Consume CTDG event pushes; emit one delta item per closed window.

    ``push(stream)`` buffers validated events (each push must be
    time-sorted and may not reach back into a closed window).
    ``close_window()`` binds the next window: it takes the buffered
    events the policy assigns to it, rolls the alive set forward
    (snapshot policy; strict — a delete of a never-inserted edge raises)
    or collects the window's unique observed insertions (window policy),
    and returns ``(item, frame)`` — the encoded delta-stream item the
    :class:`~repro_torch.stream.prefetch.DeltaApplier` consumes plus the
    window's degree-feature frame.

    ``keep_history=True`` additionally records each closed window's raw
    snapshot — the replay source for the cold path
    (``ServeEngine.cold_query_nodes``) and for late-joining consumers.
    """

    def __init__(self, spec: IngestSpec, num_nodes: int,
                 report: StreamReport | None = None,
                 keep_history: bool = False):
        spec.validate()
        if num_nodes < 1:
            raise ValueError(f"num_nodes must be >= 1, got {num_nodes}")
        self.spec = spec
        self.num_nodes = num_nodes
        self.report = report if report is not None else StreamReport()
        self.next_window = 0
        self.events_ingested = 0
        self._alive = AliveSet(num_nodes)
        self._enc = IncrementalEncoder(
            num_nodes, spec.max_edges, spec.block_size,
            spec.drop_add_pad, spec.drop_add_pad,
            on_overflow="resync", report=self.report)
        # open-event buffer: one (src, dst, time, kind) tuple per push,
        # concatenated lazily at window close
        self._buf: list[tuple[np.ndarray, ...]] = []
        self.history: list[np.ndarray] | None = [] if keep_history else None

    # ------------------------------------------------------------- ingest --
    def push(self, stream: EventStream) -> int:
        """Buffer one push of events; returns events accepted so far.

        Per-push validation only (sortedness, ids, kinds, finite times) —
        delete-before-insert is inherently a cross-push property online,
        so it is enforced where the history lives: strictly, by the
        alive set, at window close.
        """
        if stream.num_nodes != self.num_nodes:
            raise ValueError(
                f"push has num_nodes={stream.num_nodes} but the ingester "
                f"serves {self.num_nodes} nodes")
        stream.validate(require_sorted=True, check_deletes=False)
        win = self.spec.window_of(stream.time)
        if win.min() < self.next_window:
            i = int(np.nonzero(win < self.next_window)[0][0])
            raise LateEventError(float(stream.time[i]), int(win[i]),
                                 self.next_window)
        self._buf.append((np.asarray(stream.src), np.asarray(stream.dst),
                          np.asarray(stream.time), np.asarray(stream.kind)))
        self.events_ingested += len(stream)
        return self.events_ingested

    @property
    def buffered_events(self) -> int:
        return sum(s.shape[0] for s, _, _, _ in self._buf)

    # ------------------------------------------------------ window close ---
    def _take_window(self, k: int) -> tuple[np.ndarray, ...]:
        """Pop window k's events from the buffer, in stable time order."""
        if not self._buf:
            return (np.zeros(0, np.int32),) * 2 + (np.zeros(0),
                                                   np.zeros(0, np.int8))
        src = np.concatenate([b[0] for b in self._buf])
        dst = np.concatenate([b[1] for b in self._buf])
        time = np.concatenate([b[2] for b in self._buf])
        kind = np.concatenate([b[3] for b in self._buf])
        order = np.argsort(time, kind="stable")
        src, dst, time, kind = (src[order], dst[order], time[order],
                                kind[order])
        win = self.spec.window_of(time)
        sel = win == k
        keep = win > k
        self._buf = [(src[keep], dst[keep], time[keep], kind[keep])] \
            if keep.any() else []
        return src[sel], dst[sel], time[sel], kind[sel]

    def close_window(self) -> tuple[FullSnapshot | SnapshotDelta,
                                    np.ndarray]:
        """Bind the next window -> (encoded stream item, frame (N, 2))."""
        k = self.next_window
        if self.spec.num_windows and k >= self.spec.num_windows:
            raise ValueError(f"all {self.spec.num_windows} windows already "
                             "closed")
        src, dst, _, kind = self._take_window(k)
        if self.spec.policy == "snapshot":
            self._alive.apply(src, dst, kind, strict=True)
            snap = self._alive.snapshot()
        else:
            ins = kind > 0
            e = np.stack([src[ins], dst[ins]], axis=1).astype(np.int32)
            snap = np.unique(e, axis=0) if e.size \
                else np.zeros((0, 2), np.int32)
        if snap.shape[0] > self.spec.max_edges:
            raise ValueError(
                f"window {k} has {snap.shape[0]} alive edges, over the "
                f"configured max_edges={self.spec.max_edges}; serving "
                "bounds device memory up front — raise max_edges")
        self.next_window = k + 1
        if self.history is not None:
            self.history.append(snap)
        frame = generate.degree_features(snap, self.num_nodes)
        return self._enc.encode(snap), frame

    def replay(self):
        """Re-encode the kept history from scratch (fresh encoder) —
        the cold path: what serving would cost without resident state."""
        if self.history is None:
            raise ValueError("replay needs keep_history=True")
        enc = IncrementalEncoder(
            self.num_nodes, self.spec.max_edges, self.spec.block_size,
            self.spec.drop_add_pad, self.spec.drop_add_pad,
            on_overflow="resync")
        for snap in self.history:
            yield enc.encode(snap), generate.degree_features(
                snap, self.num_nodes)
