"""Graph-difference based host->device snapshot transfer (paper §3.2).

Consecutive snapshots of a real dynamic graph share most of their
topology, so the host ships, per step, the positions of edges that
DISAPPEAR (a drop list into the previous device buffer), the edges that
APPEAR, and the new snapshot's values.  The host-side types and key
function are copies of ``repro.core.graphdiff``; ``apply_delta`` — the
device-side reconstruction of the padded edge list — is written in torch
and held exactly equal to the JAX version by ``tests/test_torch_stream.py``.
On the H100 the scarce link is PCIe host -> device, the link the paper
measured.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def _edge_key(edges: np.ndarray, num_nodes: int) -> np.ndarray:
    return edges[:, 0].astype(np.int64) * num_nodes \
        + edges[:, 1].astype(np.int64)


@dataclass
class SnapshotDelta:
    """Delta between consecutive snapshots (padded, static shapes).

    Fields are numpy arrays on the host and tensors once staged."""
    drop_pos: np.ndarray    # (D_max,) int32 positions into prev edge list
    drop_mask: np.ndarray   # (D_max,) f32
    add_edges: np.ndarray   # (A_max, 2) int32
    add_mask: np.ndarray    # (A_max,) f32
    values: np.ndarray      # (E_max,) f32 — values of the new snapshot
    num_edges: int          # valid edge count of the new snapshot

    @property
    def payload_bytes(self) -> int:
        """Bytes actually shipped (valid lanes only, like the paper counts)."""
        d = int(self.drop_mask.sum())
        a = int(self.add_mask.sum())
        return d * 4 + a * 8 + self.num_edges * 4


@dataclass
class FullSnapshot:
    edges: np.ndarray   # (E_max, 2)
    mask: np.ndarray    # (E_max,)
    values: np.ndarray  # (E_max,)
    num_edges: int

    @property
    def payload_bytes(self) -> int:
        return self.num_edges * 8 + self.num_edges * 4


def naive_bytes(snapshots: list[np.ndarray]) -> int:
    """Baseline: full (indices, values) per snapshot (paper's `Base`)."""
    return sum(s.shape[0] * 12 for s in snapshots)


def apply_delta(prev_edges: torch.Tensor, prev_mask: torch.Tensor,
                drop_pos: torch.Tensor, drop_mask: torch.Tensor,
                add_edges: torch.Tensor, add_mask: torch.Tensor,
                out_edges: torch.Tensor | None = None,
                out_mask: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Device-side reconstruction of the next snapshot's padded edge list.

    1. Invalidate dropped positions in the previous buffer.
    2. Compact surviving edges to the front (stable sort on validity).
    3. Append the added edges after the survivors.

    ``out_edges`` (E_max + 1, 2) / ``out_mask`` (E_max + 1,) receive the
    result in place when given (the ``DeltaApplier`` ring slot); their last
    row is the dump row that out-of-range adds land in, the counterpart of
    JAX's ``mode="drop"``.  Returns views of the first E_max rows.  Stays
    on the device: no host synchronisation.
    """
    e_max = prev_edges.shape[0]
    dev = prev_edges.device
    if out_edges is None:
        out_edges = torch.empty((e_max + 1, 2), dtype=prev_edges.dtype,
                                device=dev)
        out_mask = torch.empty((e_max + 1,), dtype=prev_mask.dtype,
                               device=dev)
    pos = drop_pos.long()
    in_range = (pos >= 0) & (pos < e_max)
    dropped = torch.zeros_like(prev_mask).index_add_(
        0, torch.where(in_range, pos, 0),
        torch.where(in_range, drop_mask, 0.0))
    keep = torch.clamp(prev_mask * (1.0 - dropped), 0.0, 1.0)
    # stable compaction: order by (not kept), preserving original order
    order = torch.sort(1.0 - keep, stable=True).indices
    surv_mask = keep[order]
    n_surv = surv_mask.sum().to(torch.int64)
    add_count = torch.cumsum(add_mask.to(torch.int64), 0) - 1
    tgt = torch.where(add_mask > 0, n_surv + add_count, e_max)
    tgt = torch.clamp(tgt, max=e_max)            # e_max = the dump row
    torch.mul(prev_edges[order], surv_mask[:, None].to(prev_edges.dtype),
              out=out_edges[:e_max])
    out_mask[:e_max] = surv_mask
    out_edges.index_put_((tgt,), add_edges.to(out_edges.dtype))
    out_mask.index_put_((tgt,), add_mask.to(out_mask.dtype))
    return out_edges[:e_max], out_mask[:e_max]
