"""Asynchronous host->device delta streaming and the on-device edge ring.

Port of ``repro.stream.prefetch``.

* ``stage_item`` copies a stream item's arrays into pinned host memory and
  enqueues ``non_blocking`` copies to the card on the current CUDA stream.
* ``PrefetchIterator`` runs the host encoder and the staging on a
  background thread, up to ``depth`` items ahead of the consumer.  On the
  card the worker stages on its own CUDA stream (:class:`SideStream`), so
  the copies run on the copy engine while the compute stream trains: each
  staged item carries an event recorded after its copies, and the consumer
  makes its current stream wait on that event and ``record_stream``s each
  staged tensor on it before reading (the caching allocator then keeps the
  block from the next item until the step that reads it has run).
* ``DeltaApplier`` owns a preallocated 2-slot ring of (edges, mask) buffers
  on the device: each delta is applied from the current slot into the
  retiring one — where JAX donated the previous buffers, the port writes
  into the slot in place, so the stream runs in O(ring) device memory
  regardless of its length.  A ``QuantizedDelta`` (the narrow
  ``stream.wire`` format) crosses the link in its narrow dtypes and is
  widened and dequantized on the device before it is applied.
* ``SlotStacker`` copies each reconstructed snapshot of a slice out of the
  ring before the next ``consume`` overwrites it (the streamed trainer's
  ``slice_len > 1`` schedule).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.core import graphdiff
from repro_torch.core.graphdiff import FullSnapshot, SnapshotDelta
from repro_torch.stream.wire import QuantizedDelta

_SENTINEL = object()


def _identity(x: Any) -> Any:
    return x


class PrefetchIterator:
    """Stage items of ``host_iter`` on a background thread.

    ``stage_fn`` runs on the worker; the bounded queue applies
    backpressure so at most ``depth`` staged items exist at once.  Without
    a ``stage_fn`` the worker stages onto ``device`` through a
    :class:`SideStream` and ``__next__`` hands out items that are ready on
    the consumer's current stream; a given ``stage_fn``'s results are
    handed out as they are.  Exceptions on the worker are re-raised at the
    consumer's next ``__next__``; the iterator stays terminated
    (StopIteration) afterwards.  ``close()`` (also via the context-manager
    protocol) unblocks and retires the worker when the consumer abandons
    the stream early, releasing the staged buffers.
    """

    # _err is written by the worker and read by the consumer WITHOUT a
    # lock: the write happens-before the sentinel put, and the consumer
    # reads it only after get() returned that sentinel — the queue's
    # internal lock is the synchronization edge (dynlint: locks pass).
    _thread_owned = ("_err",)

    def __init__(self, host_iter: Iterable, stage_fn: Callable | None = None,
                 depth: int = 2, device: str | torch.device = "cuda"):
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        if stage_fn is None:
            side = SideStream(device)
            self._stage, self._receive = side.stage, side.receive
        else:
            self._stage, self._receive = stage_fn, _identity
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(
            target=self._worker, args=(iter(host_iter),), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that still observes close(); False = shut down."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, it: Iterator) -> None:
        trc = obs.get_tracer()
        try:
            for item in it:
                if self._stop.is_set():
                    return
                # staging span lives on the worker thread's trace track,
                # so overlap with the consumer's step spans is visible
                with trc.span("prefetch.stage", cat="prefetch"):
                    staged = self._stage(item)
                obs.inc("prefetch.items")
                if not self._put(staged):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised on consumer
            self._err = e
        finally:
            self._put(_SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        with obs.span("prefetch.wait", cat="prefetch"):
            item = self._q.get()
        if item is _SENTINEL:
            self._done = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        return self._receive(item)

    def close(self) -> None:
        """Retire the worker and drop staged items (idempotent)."""
        self._stop.set()
        self._done = True
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=1.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _put(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        # pinned staging copy -> asynchronous DMA on the current stream; the
        # caching host allocator keeps the pinned block alive until the
        # copy has run
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def stage_item(item: Any, device: str | torch.device = "cuda") -> Any:
    """Ship one stream item's arrays to ``device`` (tuples recurse)."""
    dev = resolve_device(device)
    if isinstance(item, tuple):
        return tuple(stage_item(x, dev) for x in item)
    if isinstance(item, FullSnapshot):
        return FullSnapshot(edges=_put(item.edges, dev),
                            mask=_put(item.mask, dev),
                            values=_put(item.values, dev),
                            num_edges=item.num_edges)
    if isinstance(item, SnapshotDelta):
        return SnapshotDelta(drop_pos=_put(item.drop_pos, dev),
                             drop_mask=_put(item.drop_mask, dev),
                             add_edges=_put(item.add_edges, dev),
                             add_mask=_put(item.add_mask, dev),
                             values=_put(item.values, dev),
                             num_edges=item.num_edges)
    if isinstance(item, QuantizedDelta):
        # the narrow dtypes cross the host->device link as they are; the
        # ring widens them on the device (DeltaApplier.consume)
        return QuantizedDelta(drop_pos=_put(item.drop_pos, dev),
                              drop_mask=_put(item.drop_mask, dev),
                              add_edges=_put(item.add_edges, dev),
                              add_mask=_put(item.add_mask, dev),
                              values_q=_put(item.values_q, dev),
                              values_scale=item.values_scale,
                              num_edges=item.num_edges)
    return _put(item, dev)


def _tensors(item: Any) -> Iterator[torch.Tensor]:
    """Every tensor of a staged item (tuples and item dataclasses)."""
    if isinstance(item, torch.Tensor):
        yield item
    elif isinstance(item, tuple):
        for x in item:
            yield from _tensors(x)
    elif dataclasses.is_dataclass(item):
        for f in dataclasses.fields(item):
            yield from _tensors(getattr(item, f.name))


@dataclasses.dataclass
class Staged:
    """A stream item staged on a side stream, and the event recorded on
    that stream after its copies (``None`` on the CPU)."""
    item: Any
    ready: torch.cuda.Event | None


class SideStream:
    """The prefetch worker's staging onto ``device``.

    On the card :meth:`stage` (worker thread) enqueues an item's pinned,
    ``non_blocking`` copies on a CUDA stream of its own and records an
    event after them; :meth:`receive` (consumer thread) makes the
    consumer's current stream wait on that event and ``record_stream``s
    every staged tensor on it.  On the CPU both pass the item through
    ``stage_item``."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def stage(self, item: Any) -> Staged:
        if self.stream is None:
            return Staged(stage_item(item, self.device), None)
        with torch.cuda.stream(self.stream):
            staged = stage_item(item, self.device)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return Staged(staged, ready)

    def receive(self, staged: Staged) -> Any:
        if staged.ready is None:
            return staged.item
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(staged.ready)
        for t in _tensors(staged.item):
            t.record_stream(compute)
        return staged.item


class DeltaApplier:
    """Device-resident (edges, mask) buffer ring with two slots.

    ``consume`` turns a staged stream item into the current snapshot's
    device buffers, written into the retiring slot: a full snapshot is
    copied in, a delta is applied from the current slot by
    ``graphdiff.apply_delta``; a ``QuantizedDelta``'s indices and masks
    are widened (int32, f32) and its values dequantized (``q * scale``, in
    f32) on the device first.  Each slot has one extra dump row that
    out-of-range adds land in.  The returned tensors are views of the new
    current slot and stay valid until the next ``consume`` (the contract
    of the JAX ring, whose buffers the next call donated).
    """

    def __init__(self, max_edges: int, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.max_edges = max_edges
        self._edges = torch.zeros((2, max_edges + 1, 2), dtype=torch.int32,
                                  device=self.device)
        self._mask = torch.zeros((2, max_edges + 1), dtype=torch.float32,
                                 device=self.device)
        self._cur = 0

    @property
    def current(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(edges (E_max, 2), mask (E_max,)) of the current snapshot."""
        return (self._edges[self._cur, :self.max_edges],
                self._mask[self._cur, :self.max_edges])

    def consume(self, item) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
        """-> (edges, mask, values) device tensors for this step."""
        nxt = 1 - self._cur
        out_e, out_m = self._edges[nxt], self._mask[nxt]
        dev = self.device
        if isinstance(item, FullSnapshot):
            out_e[:self.max_edges].copy_(item.edges)
            out_m[:self.max_edges].copy_(item.mask)
            values = torch.as_tensor(item.values, device=dev)
        elif isinstance(item, SnapshotDelta):
            prev_e, prev_m = self.current
            graphdiff.apply_delta(prev_e, prev_m, item.drop_pos,
                                  item.drop_mask, item.add_edges,
                                  item.add_mask, out_edges=out_e,
                                  out_mask=out_m)
            values = torch.as_tensor(item.values, device=dev)
        elif isinstance(item, QuantizedDelta):
            prev_e, prev_m = self.current

            def wide(a, dtype):
                return torch.as_tensor(a, device=dev).to(dtype)

            graphdiff.apply_delta(
                prev_e, prev_m, wide(item.drop_pos, torch.int32),
                wide(item.drop_mask, torch.float32),
                wide(item.add_edges, torch.int32),
                wide(item.add_mask, torch.float32),
                out_edges=out_e, out_mask=out_m)
            values = wide(item.values_q, torch.float32) * float(
                item.values_scale)
        else:
            raise TypeError(f"DeltaApplier cannot consume "
                            f"{type(item).__name__}")
        self._cur = nxt
        return (*self.current, values)


class SlotStacker:
    """Slot staging for slice-granularity streaming.

    A slice step reconstructs ``slots`` consecutive snapshots before one
    step consumes them all.  The applier's ring overwrites its buffers on
    the next ``consume``, so each reconstructed snapshot is copied out
    first: ``put(j, ...)`` makes one O(E) copy per buffer (stream order
    puts the read before the next apply overwrites the slot), and
    ``arrays()`` stacks the slots into fresh (slots, E, ...) tensors once
    per slice — nothing the step reads aliases the ring.
    """

    def __init__(self, slots: int):
        self._slots: list = [None] * slots

    def put(self, j: int, edges: torch.Tensor, mask: torch.Tensor,
            values: torch.Tensor) -> None:
        self._slots[j] = (edges.clone(), mask.clone(), values.clone())

    def arrays(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (edges (slots, E, 2), mask (slots, E), values (slots, E))."""
        es, ms, vs = zip(*self._slots, strict=True)
        return torch.stack(es), torch.stack(ms), torch.stack(vs)
