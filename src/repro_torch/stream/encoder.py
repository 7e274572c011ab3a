"""Vectorized host-side graph-diff encoder.

Host numpy, a copy of ``repro.stream.encoder`` whose items are held
byte-identical to the reference's by ``tests/test_torch_stream.py``.  Only
the lossless ``wire="none"`` format is ported; the narrow int8 wire
(``repro.stream.wire``) waits for ROADMAP Queue 1, item 7.

Replaces the reference encoder's per-edge python dict alignment
(``core.graphdiff.encode_stream``) with ``np.searchsorted`` set algebra:

* membership (drop/add selection) via one sort of each key array,
* value alignment of the new device ordering via a stable argsort +
  searchsorted gather — no python-level per-edge work at all.

It also sizes the drop/add pads from DATASET STATISTICS (the actual max
churn over the trace, rounded up) instead of ``max_edges``: real traces
churn a few percent of edges per step, so stats-sized pads shrink the
staged host buffers and the per-delta ``device_put`` by ~1/churn.

Output is bit-identical to the reference encoder (same drop positions,
same device-order survivors+adds, same aligned values) — only the pad
lengths differ, which ``apply_delta`` is agnostic to.  Verified in
tests/test_stream.py (reference) and tests/test_torch_stream.py (port).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from repro_torch import obs
from repro_torch.core.graphdiff import FullSnapshot, SnapshotDelta, _edge_key


class ChurnOverflowError(ValueError):
    """Measured churn at one step exceeds the stats-sized delta pads."""

    def __init__(self, drops: int, adds: int, drop_pad: int, add_pad: int):
        self.drops, self.adds = drops, adds
        self.drop_pad, self.add_pad = drop_pad, add_pad
        super().__init__(
            f"churn ({drops} drops / {adds} adds) exceeds stats pad "
            f"({drop_pad}/{add_pad}); re-measure stats")


@dataclass
class StreamReport:
    """Mutable per-stream health counters (shared with the caller).

    ``resyncs`` counts delta steps that overflowed the stats pads and were
    downgraded to FullSnapshot resyncs — a long-running stream whose live
    churn drifts past the measured trace statistics degrades (extra full
    payloads) instead of crashing mid-training.
    """
    resyncs: int = 0
    worst_drops: int = 0
    worst_adds: int = 0
    resync_steps: list = field(default_factory=list)

    def note_overflow(self, step: int, err: ChurnOverflowError) -> None:
        self.resyncs += 1
        self.worst_drops = max(self.worst_drops, err.drops)
        self.worst_adds = max(self.worst_adds, err.adds)
        self.resync_steps.append(step)
        # mirror into the shared namespace (docs/observability.md)
        obs.inc("stream.resyncs")


@dataclass(frozen=True)
class DeltaStats:
    """Pad sizing derived from one pass over the trace's key sets."""
    max_edges: int
    max_drops: int
    max_adds: int

    @property
    def churn_pad(self) -> int:
        return max(self.max_drops, self.max_adds)


def _round_up(v: int, m: int) -> int:
    return max(((v + m - 1) // m) * m, m)


def padded_max_edges(snapshots, multiple: int = 128) -> int:
    """Trace-wide E_max rounded up to the device lane multiple — the one
    edge-pad sizing rule shared by the trainer, benchmarks, and tests."""
    return _round_up(max(s.shape[0] for s in snapshots), multiple)


def measure_stats(snapshots: list[np.ndarray], num_nodes: int,
                  block_size: int, max_edges: int,
                  pad_multiple: int = 64) -> DeltaStats:
    """Max drop/add counts over the trace (delta steps only), padded up.

    Counts are set-cardinalities of consecutive snapshot key sets, so one
    vectorized pass suffices — no device-order simulation needed.
    """
    max_d = max_a = 0
    prev_keys: np.ndarray | None = None
    for i, snap in enumerate(snapshots):
        keys = np.sort(_edge_key(snap, num_nodes))
        if i % block_size != 0 and prev_keys is not None:
            common = np.intersect1d(prev_keys, keys,
                                    assume_unique=False).shape[0]
            max_d = max(max_d, prev_keys.shape[0] - common)
            max_a = max(max_a, keys.shape[0] - common)
        prev_keys = keys
    pad = min(_round_up(max(max_d, max_a, 1), pad_multiple), max_edges)
    return DeltaStats(max_edges=max_edges, max_drops=pad, max_adds=pad)


@dataclass
class _DeviceMirror:
    """Host mirror of the device buffer between delta steps.

    Carrying keys forward kills the two redundant sorts of the naive
    formulation: the device keys in device order are concat(kept, added)
    from last step, and the SORTED device keys are exactly the previous
    snapshot's sorted keys (same set).
    """
    edges: np.ndarray        # (E_dev, 2) device-order edge list
    keys: np.ndarray         # (E_dev,) int64 keys, device order
    keys_sorted: np.ndarray  # (E_dev,) int64 keys, ascending


def _delta_step(dev: _DeviceMirror, snap: np.ndarray, vals: np.ndarray,
                num_nodes: int, max_edges: int, drop_pad: int,
                add_pad: int) -> tuple[SnapshotDelta, _DeviceMirror]:
    """One vectorized delta against the current device ordering."""
    pk = dev.keys
    ck = _edge_key(snap, num_nodes)
    ck_order = np.argsort(ck, kind="stable")
    ck_sorted = ck[ck_order]
    # prev edges still present in the current snapshot (+ where, for the
    # value alignment below)
    pos = np.searchsorted(ck_sorted, pk)
    np.minimum(pos, max(ck_sorted.shape[0] - 1, 0), out=pos)
    keep_sel = (ck_sorted[pos] == pk) if ck_sorted.size else \
        np.zeros(pk.shape, dtype=bool)
    # current edges not present in the previous snapshot
    cpos = np.searchsorted(dev.keys_sorted, ck)
    np.minimum(cpos, max(dev.keys_sorted.shape[0] - 1, 0), out=cpos)
    add_sel = (dev.keys_sorted[cpos] != ck) if dev.keys_sorted.size else \
        np.ones(ck.shape, dtype=bool)

    drop_pos = np.nonzero(~keep_sel)[0].astype(np.int32)
    adds = snap[add_sel]
    if drop_pos.shape[0] > drop_pad or adds.shape[0] > add_pad:
        raise ChurnOverflowError(drop_pos.shape[0], adds.shape[0],
                                 drop_pad, add_pad)

    dp = np.zeros((drop_pad,), dtype=np.int32)
    dm = np.zeros((drop_pad,), dtype=np.float32)
    dp[:drop_pos.shape[0]] = drop_pos
    dm[:drop_pos.shape[0]] = 1.0
    ae = np.zeros((add_pad, 2), dtype=np.int32)
    am = np.zeros((add_pad,), dtype=np.float32)
    ae[:adds.shape[0]] = adds
    am[:adds.shape[0]] = 1.0

    # New device order: survivors (device order) then adds.  Values align
    # without another search: a survivor's key sits at ck_sorted[pos], i.e.
    # original snapshot position ck_order[pos]; adds map directly.
    new_dev = np.concatenate([dev.edges[keep_sel], adds], axis=0)
    v_valid = np.concatenate([vals[ck_order[pos[keep_sel]]], vals[add_sel]])
    v = np.zeros((max_edges,), dtype=np.float32)
    v[:v_valid.shape[0]] = v_valid
    new_keys = np.concatenate([pk[keep_sel], ck[add_sel]])
    mirror = _DeviceMirror(edges=new_dev, keys=new_keys,
                           keys_sorted=ck_sorted)
    return SnapshotDelta(drop_pos=dp, drop_mask=dm, add_edges=ae,
                         add_mask=am, values=v,
                         num_edges=snap.shape[0]), mirror


def _full_step(snap: np.ndarray, vals: np.ndarray,
               max_edges: int) -> FullSnapshot:
    e = np.zeros((max_edges, 2), dtype=np.int32)
    m = np.zeros((max_edges,), dtype=np.float32)
    v = np.zeros((max_edges,), dtype=np.float32)
    e[:snap.shape[0]] = snap
    m[:snap.shape[0]] = 1.0
    v[:snap.shape[0]] = vals
    return FullSnapshot(edges=e, mask=m, values=v, num_edges=snap.shape[0])


class IncrementalEncoder:
    """The delta encoder as an online consumer: one snapshot at a time.

    Holds the device-mirror state (``_DeviceMirror``) between calls so a
    LIVE stream — snapshots that materialize window by window, e.g. from
    the CTDG ingester (``repro_torch.serve.ingest``) — encodes without ever
    materializing the trace.  Its items are byte-identical to the JAX
    package's encoder on the same snapshots (``tests/test_torch_stream.py``).

    ``on_overflow`` governs steps whose measured churn exceeds the
    sized pads (always possible online, where pads come from a config or
    from a different trace's statistics):

    * ``"resync"`` (default) — ship that step as a FullSnapshot resync
      (the decoder treats it like a block boundary), warn once, and count
      it on ``report``; long-running streams degrade instead of crashing.
    * ``"raise"`` — propagate :class:`ChurnOverflowError` (strict mode
      for offline encoding where stats are authoritative).

    Only ``wire="none"`` (lossless f32) is ported; any other wire raises
    ``NotImplementedError`` until ROADMAP Queue 1, item 7 ports ``stream/wire.py``.
    """

    def __init__(self, num_nodes: int, max_edges: int, block_size: int,
                 drop_pad: int, add_pad: int, on_overflow: str = "resync",
                 report: StreamReport | None = None, wire: str = "none"):
        if on_overflow not in ("resync", "raise"):
            raise ValueError(f"on_overflow must be resync|raise, "
                             f"got {on_overflow!r}")
        self.num_nodes = num_nodes
        self.max_edges = max_edges
        self.block_size = block_size
        self.drop_pad = drop_pad
        self.add_pad = add_pad
        self.on_overflow = on_overflow
        self.report = report
        if wire != "none":
            raise NotImplementedError(
                f"wire={wire!r} is not ported yet (ROADMAP Queue 1, item 7 ports "
                "stream/wire.py); the port supports wire='none'")
        self.wire = wire
        self.step = 0
        self._dev: _DeviceMirror | None = None
        self._warned = False

    def _full_resync(self, snap, vals):
        keys = _edge_key(snap, self.num_nodes)
        self._dev = _DeviceMirror(edges=snap.copy(), keys=keys,
                                  keys_sorted=np.sort(keys))
        return _full_step(snap, vals, self.max_edges)

    def encode(self, snap: np.ndarray, vals: np.ndarray | None = None
               ) -> FullSnapshot | SnapshotDelta:
        """Encode the next snapshot against the mirrored device state."""
        if vals is None:
            vals = np.ones((snap.shape[0],), dtype=np.float32)
        i, self.step = self.step, self.step + 1
        if i % self.block_size == 0:
            return self._full_resync(snap, vals)
        try:
            item, self._dev = _delta_step(
                self._dev, snap, vals, self.num_nodes, self.max_edges,
                self.drop_pad, self.add_pad)
            return item
        except ChurnOverflowError as err:
            if self.on_overflow == "raise":
                raise
            if self.report is not None:
                self.report.note_overflow(i, err)
            if not self._warned:
                # once per stream: a long-drifted stream can resync on
                # many steps and must not flood stderr — the report
                # carries the per-step detail
                warnings.warn(
                    f"delta stream step {i}: {err}; emitting "
                    "FullSnapshot resync (further overflows counted "
                    "on StreamReport, not warned)", stacklevel=2)
                self._warned = True
            return self._full_resync(snap, vals)


def iter_encode_stream(snapshots: list[np.ndarray],
                       values: list[np.ndarray] | None,
                       num_nodes: int, max_edges: int, block_size: int,
                       stats: DeltaStats | None = None,
                       on_overflow: str = "resync",
                       report: StreamReport | None = None,
                       wire: str = "none") -> Iterator:
    """Lazily encode the trace (the form the prefetch thread consumes).

    A loop over :class:`IncrementalEncoder` (which documents the
    ``on_overflow`` and ``wire`` modes) with stats-sized delta pads
    measured from the trace when not provided.
    """
    if stats is None:
        stats = measure_stats(snapshots, num_nodes, block_size, max_edges)
    inc = IncrementalEncoder(num_nodes, max_edges, block_size,
                             stats.max_drops, stats.max_adds,
                             on_overflow=on_overflow, report=report,
                             wire=wire)
    for i, snap in enumerate(snapshots):
        yield inc.encode(snap, values[i] if values is not None else None)


def encode_stream_fast(snapshots: list[np.ndarray],
                       values: list[np.ndarray] | None,
                       num_nodes: int, max_edges: int, block_size: int,
                       stats: DeltaStats | None = None,
                       on_overflow: str = "resync",
                       report: StreamReport | None = None,
                       wire: str = "none") -> list:
    """The whole trace encoded at once: ``list(iter_encode_stream(...))``."""
    return list(iter_encode_stream(snapshots, values, num_nodes, max_edges,
                                   block_size, stats, on_overflow, report,
                                   wire=wire))
