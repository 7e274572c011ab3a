"""Host->device delta staging and the on-device edge-buffer ring.

Port of ``stage_item`` and ``DeltaApplier`` from
``repro.stream.prefetch``.  ``stage_item`` copies a stream item's arrays
into pinned host memory and issues ``non_blocking`` copies to the card, so
the transfer runs on the copy engine while the host goes on.
``DeltaApplier`` owns a preallocated 2-slot ring of (edges, mask) buffers
on the device: each delta is applied from the current slot into the
retiring one — where JAX donated the previous buffers, the port writes
into the slot in place, so the stream runs in O(ring) device memory
regardless of its length.  ``PrefetchIterator`` and ``SlotStacker`` wait
for the streamed trainer (ROADMAP Queue 1, item 6).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import graphdiff
from repro_torch.core.graphdiff import FullSnapshot, SnapshotDelta


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
    return _put(item, dev)


class DeltaApplier:
    """Device-resident (edges, mask) buffer ring with two slots.

    ``consume`` turns a staged stream item into the current snapshot's
    device buffers, written into the retiring slot: a full snapshot is
    copied in, a delta is applied from the current slot by
    ``graphdiff.apply_delta``.  Each slot has one extra dump row that
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
        if isinstance(item, FullSnapshot):
            out_e[:self.max_edges].copy_(item.edges)
            out_m[:self.max_edges].copy_(item.mask)
        elif isinstance(item, SnapshotDelta):
            prev_e, prev_m = self.current
            graphdiff.apply_delta(prev_e, prev_m, item.drop_pos,
                                  item.drop_mask, item.add_edges,
                                  item.add_mask, out_edges=out_e,
                                  out_mask=out_m)
        else:
            raise TypeError(f"DeltaApplier cannot consume "
                            f"{type(item).__name__}")
        self._cur = nxt
        return (*self.current, torch.as_tensor(item.values,
                                               device=self.device))
