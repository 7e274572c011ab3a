"""CTDG -> DTDG bridging (paper §7 future-work item iii).

Host numpy, a copy of ``repro.core.ctdg`` held byte-identical to it by
``tests/test_torch_stream.py`` (the port imports nothing of ``repro``).

Continuous-Time Dynamic Graphs arrive as timestamped event streams
(edge insertions/deletions).  The paper's entire machinery is DTDG-based;
this module discretizes a CTDG into the snapshot sequence the rest of the
framework consumes — including the two discretization policies used in
practice:

  * ``snapshot_events``  — G_t = edges alive at the end of window t
    (insertions minus deletions), the exact-state view;
  * ``window_events``    — G_t = edges *observed* during window t
    (interaction graphs, e.g. transactions), the view the paper's
    epinions/AMLSim datasets use.

Because consecutive windows share most alive edges, the output plugs
directly into the graph-difference transfer encoder with high overlap.

The window assignment rules and the alive-edge bookkeeping are factored
out (``uniform_bounds`` / ``snapshot_window_index`` /
``interaction_window_index`` / ``AliveSet``) so the ONLINE ingester
(``repro_torch.serve.ingest``) consumes events through literally the same code
paths — a live stream discretizes onto exactly the windows the offline
functions would produce, which is what pins online serving to the
offline reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

POLICIES = ("snapshot", "window")


@dataclass
class EventStream:
    """Timestamped edge events: kind +1 = insert, -1 = delete."""
    src: np.ndarray          # (M,) int
    dst: np.ndarray          # (M,) int
    time: np.ndarray         # (M,) float, non-decreasing not required
    kind: np.ndarray         # (M,) int8 in {+1, -1}
    num_nodes: int

    def __len__(self) -> int:
        return int(self.src.shape[0])

    def sorted(self) -> "EventStream":
        order = np.argsort(self.time, kind="stable")
        return EventStream(self.src[order], self.dst[order],
                           self.time[order], self.kind[order],
                           self.num_nodes)

    def validate(self, require_sorted: bool = False,
                 check_deletes: bool = True) -> "EventStream":
        """Reject malformed streams with a clear message (returns self).

        Checks: matching array lengths, non-empty, node ids within
        ``[0, num_nodes)``, kinds in {+1, -1}, finite timestamps, and —
        with ``check_deletes`` — that no edge is deleted more times than
        it was inserted up to that point (delete-before-insert), in
        stable time order.  ``require_sorted`` additionally demands
        non-decreasing timestamps (the contract of live ingest pushes;
        the offline discretizers sort for you).  Silently feeding any of
        these through the discretizers would produce wrong windows, so
        they raise here instead.
        """
        m = len(self)
        for name in ("dst", "time", "kind"):
            a = getattr(self, name)
            if a.shape[0] != m:
                raise ValueError(
                    f"EventStream.{name} has {a.shape[0]} events but src "
                    f"has {m}; all event arrays must align")
        if m == 0:
            raise ValueError("EventStream is empty: nothing to discretize")
        if self.num_nodes <= 0:
            raise ValueError(f"EventStream.num_nodes must be positive, "
                             f"got {self.num_nodes}")
        for name in ("src", "dst"):
            a = getattr(self, name)
            if a.min() < 0 or a.max() >= self.num_nodes:
                bad = int(a[(a < 0) | (a >= self.num_nodes)][0])
                raise ValueError(
                    f"EventStream.{name} contains node id {bad} outside "
                    f"[0, {self.num_nodes}); fix the ids or num_nodes")
        if not np.isin(self.kind, (-1, 1)).all():
            bad = self.kind[~np.isin(self.kind, (-1, 1))][0]
            raise ValueError(f"EventStream.kind must be +1 (insert) or -1 "
                             f"(delete), got {int(bad)}")
        if not np.isfinite(self.time).all():
            raise ValueError("EventStream.time contains non-finite "
                             "timestamps")
        if require_sorted and np.any(np.diff(self.time) < 0):
            i = int(np.nonzero(np.diff(self.time) < 0)[0][0])
            raise ValueError(
                f"EventStream.time must be non-decreasing: event {i + 1} "
                f"(t={float(self.time[i + 1])}) precedes event {i} "
                f"(t={float(self.time[i])})")
        if check_deletes:
            self._check_delete_before_insert()
        return self

    def _check_delete_before_insert(self) -> None:
        """Per-edge running insert-minus-delete count must never go
        negative (vectorized: group events by edge key, keeping stable
        time order inside each group, and cumsum the kinds)."""
        order = np.argsort(self.time, kind="stable")
        keys = _edge_key(self.src[order], self.dst[order], self.num_nodes)
        grp = np.argsort(keys, kind="stable")     # stable: time order kept
        counts = np.cumsum(self.kind[order][grp].astype(np.int64))
        k_sorted = keys[grp]
        starts = np.nonzero(np.r_[True, k_sorted[1:] != k_sorted[:-1]])[0]
        sizes = np.diff(np.r_[starts, k_sorted.shape[0]])
        base = np.repeat(np.r_[0, counts[starts[1:] - 1]], sizes)
        running = counts - base
        if running.min() < 0:
            i = int(order[grp[np.nonzero(running < 0)[0][0]]])
            raise ValueError(
                f"EventStream deletes edge ({int(self.src[i])}, "
                f"{int(self.dst[i])}) at t={float(self.time[i])} before "
                "inserting it (or more times than it was inserted); "
                "delete events must follow a matching insert")


def _edge_key(src, dst, n):
    return src.astype(np.int64) * n + dst.astype(np.int64)


# ------------------------------------------------ window assignment ---------

def uniform_bounds(t0: float, t1: float, num_steps: int) -> np.ndarray:
    """End-bound of each of ``num_steps`` uniform windows over [t0, t1]."""
    return np.linspace(t0, t1, num_steps + 1)[1:]


def snapshot_window_index(time: np.ndarray, bounds: np.ndarray
                          ) -> np.ndarray:
    """Window owning each event under the alive-edge (snapshot) policy:
    the first window whose end bound is >= the event time (events beyond
    the last bound land past the final window and are never consumed —
    identical to the reference consumption loop)."""
    return np.searchsorted(bounds, time, side="left")


def interaction_window_index(time: np.ndarray, t0: float, t1: float,
                             num_steps: int) -> np.ndarray:
    """Window owning each event under the interaction (window) policy —
    the exact binning formula of ``window_events``."""
    return np.clip(((np.asarray(time) - t0) / max(t1 - t0, 1e-12)
                    * num_steps).astype(np.int64), 0, num_steps - 1)


class AliveSet:
    """Incremental alive-edge bookkeeping with reference-stable order.

    Holds the insert-minus-delete count per edge key; ``snapshot()``
    materializes the alive edge list in key *insertion* order — the same
    dict-order contract ``snapshot_events`` has always had, so feeding
    the same events through ``apply`` online or offline yields
    byte-identical snapshots.
    """

    def __init__(self, num_nodes: int):
        self.num_nodes = num_nodes
        self._alive: dict[int, int] = {}

    def apply(self, src: np.ndarray, dst: np.ndarray,
              kind: np.ndarray, strict: bool = False) -> None:
        """Apply events (already in stable time order).

        ``strict`` raises on a delete of an edge that is not currently
        alive — the running analogue of ``validate(check_deletes=True)``
        for live ingest, where no single push sees the whole history.
        """
        keys = _edge_key(np.asarray(src), np.asarray(dst), self.num_nodes)
        alive = self._alive
        n = self.num_nodes
        for k, s in zip(keys.tolist(), np.asarray(kind).tolist(),
                        strict=True):
            if s > 0:
                alive[k] = alive.get(k, 0) + 1
            else:
                c = alive.get(k, 0) - 1
                if c < 0 and strict:
                    raise ValueError(
                        f"delete of edge ({k // n}, {k % n}) which is not "
                        "alive (delete-before-insert across the ingested "
                        "stream)")
                if c <= 0:
                    alive.pop(k, None)
                else:
                    alive[k] = c

    def snapshot(self) -> np.ndarray:
        """(E, 2) int32 alive edge list, key-insertion order."""
        n = self.num_nodes
        ks = np.fromiter(self._alive.keys(), dtype=np.int64,
                         count=len(self._alive))
        if not ks.size:
            return np.zeros((0, 2), np.int32)
        return np.stack([ks // n, ks % n], axis=1).astype(np.int32)


def _validated(stream: EventStream, num_steps: int) -> EventStream:
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    return stream.validate().sorted()


def snapshot_events(stream: EventStream, num_steps: int
                    ) -> list[np.ndarray]:
    """Alive-edge snapshots at the end of each of ``num_steps`` uniform
    windows over the stream's time range."""
    ev = _validated(stream, num_steps)
    bounds = uniform_bounds(float(ev.time[0]), float(ev.time[-1]),
                            num_steps)
    win = snapshot_window_index(ev.time, bounds)
    alive = AliveSet(stream.num_nodes)
    out: list[np.ndarray] = []
    for t in range(num_steps):
        sel = win == t
        alive.apply(ev.src[sel], ev.dst[sel], ev.kind[sel])
        out.append(alive.snapshot())
    return out


def window_events(stream: EventStream, num_steps: int) -> list[np.ndarray]:
    """Interaction snapshots: unique edges observed within each window."""
    ev = _validated(stream, num_steps)
    t0, t1 = float(ev.time[0]), float(ev.time[-1])
    edges_at = interaction_window_index(ev.time, t0, t1, num_steps)
    out = []
    for t in range(num_steps):
        sel = (edges_at == t) & (ev.kind > 0)
        e = np.stack([ev.src[sel], ev.dst[sel]], axis=1).astype(np.int32)
        out.append(np.unique(e, axis=0) if e.size
                   else np.zeros((0, 2), np.int32))
    return out


def synthetic_ctdg(num_nodes: int, num_events: int, delete_frac: float = 0.2,
                   seed: int = 0) -> EventStream:
    """Synthetic event stream with slow churn (inserts then deletions of
    previously-inserted edges)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_nodes, num_events)
    dst = rng.integers(0, num_nodes, num_events)
    time = np.sort(rng.uniform(0, 1, num_events))
    kind = np.ones(num_events, np.int8)
    n_del = min(int(num_events * delete_frac), num_events // 2)
    if n_del:
        # distinct delete positions (replace=False: a repeated position
        # would overwrite itself into a double-delete of a once-inserted
        # edge, which validate() rightly rejects)
        del_idx = rng.choice(num_events // 2, n_del, replace=False)
        pos = rng.choice(np.arange(num_events // 2, num_events), n_del,
                         replace=False)
        kind[pos] = -1
        src[pos] = src[del_idx]
        dst[pos] = dst[del_idx]
    return EventStream(src.astype(np.int32), dst.astype(np.int32),
                       time, kind, num_nodes)
