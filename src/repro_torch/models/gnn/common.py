"""Shared static-graph batch container and heads of the GNN archs.

Port of ``repro.models.gnn.common``: one padded edge list, node features,
3-D positions for the molecular archs and an optional graph-id vector for
batched small graphs (disjoint union, the ``molecule`` shape).
:class:`GraphBatch` is a plain dataclass of tensors; ``.to(device)`` moves
it.  :func:`batch_molecules` is the reference's numpy generator, copied:
the same seed gives the same arrays, byte for byte.

:class:`GraphLayout` is how a rank of a grid holds a full graph over the
grid's data column (the reference's full-graph cell: edges split over
data, node tensors split by rows or replicated): the archs' ``layout``
argument, ``None`` on one rank.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.dist import sharding as shd
from repro_torch.graph import segment


@dataclass
class GraphBatch:
    edges: torch.Tensor                   # (E, 2) int32
    edge_mask: torch.Tensor               # (E,) f32
    node_feat: torch.Tensor               # (N, F) f32
    node_mask: torch.Tensor               # (N,) f32
    positions: torch.Tensor | None = None  # (N, 3) f32 or None
    graph_id: torch.Tensor | None = None   # (N,) int32 for batched graphs
    num_graphs: int = 1
    labels: torch.Tensor | None = None     # (N,) or (num_graphs,) int32

    @classmethod
    def from_arrays(cls, arrays: dict, num_graphs: int = 1,
                    device: str | torch.device = "cpu") -> GraphBatch:
        """The fields as numpy arrays (None for an absent one) -> a batch
        of tensors on ``device``."""
        return cls(num_graphs=num_graphs, **{
            k: None if v is None else torch.from_numpy(v).to(device)
            for k, v in arrays.items()})

    def to(self, device) -> GraphBatch:
        """The same batch with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


@dataclass(frozen=True)
class GraphLayout:
    """A rank's part of a full graph split over ``grid``'s data column
    (``grid.pd`` ranks): its slice of the edge lanes (global node ids) and
    its ``num_nodes / pd`` node rows, in data-index order.  Every node-side
    tensor an arch computes is this rank's rows; :meth:`whole` gathers
    them before the edges read them, and the scatters hand back this
    rank's rows of the global aggregate (``graph.segment``'s ``group`` and
    ``rows``), so each rank's gradient is its share of the global one and
    one sum over the data column gives every leaf's gradient once.  The
    model axis holds copies."""

    grid: Any
    num_nodes: int

    @property
    def group(self):
        return self.grid.data

    @property
    def rows(self) -> slice:
        """This rank's node rows."""
        n = self.num_nodes // self.grid.pd
        return slice(self.grid.data_index * n, (self.grid.data_index + 1) * n)

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a node tensor -> all N rows."""
        return shd.gather_rows(x, self.group)


def molecule_arrays(n_graphs: int, nodes_per: int, edges_per: int,
                    feat_dim: int, seed: int = 0,
                    with_positions: bool = True) -> dict:
    """The reference's ``batch_molecules`` draws, as numpy arrays."""
    rng = np.random.default_rng(seed)
    n_total = n_graphs * nodes_per
    e_total = n_graphs * edges_per
    edges = np.zeros((e_total, 2), dtype=np.int32)
    for g in range(n_graphs):
        base = g * nodes_per
        src = rng.integers(0, nodes_per, size=(edges_per,))
        # no self-loops: zero-length edge vectors have no edge frame
        # (breaks the eSCN rotation); radius graphs never contain them.
        off = rng.integers(1, nodes_per, size=(edges_per,))
        dst = (src + off) % nodes_per
        edges[g * edges_per:(g + 1) * edges_per] = \
            np.stack([src, dst], axis=1) + base
    feat = rng.normal(size=(n_total, feat_dim)).astype(np.float32)
    pos = rng.uniform(0, 5, size=(n_total, 3)).astype(np.float32) \
        if with_positions else None
    gid = np.repeat(np.arange(n_graphs, dtype=np.int32), nodes_per)
    labels = rng.integers(0, 2, size=(n_graphs,)).astype(np.int32)
    return {"edges": edges, "edge_mask": np.ones((e_total,), np.float32),
            "node_feat": feat, "node_mask": np.ones((n_total,), np.float32),
            "positions": pos, "graph_id": gid, "labels": labels}


def batch_molecules(n_graphs: int, nodes_per: int, edges_per: int,
                    feat_dim: int, seed: int = 0,
                    with_positions: bool = True,
                    device: str | torch.device = "cpu") -> GraphBatch:
    """Disjoint union of random small graphs (the ``molecule`` shape)."""
    return GraphBatch.from_arrays(
        molecule_arrays(n_graphs, nodes_per, edges_per, feat_dim, seed,
                        with_positions), n_graphs, device)


def graph_readout(x: torch.Tensor, graph_id: torch.Tensor, num_graphs: int,
                  node_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean pooling per graph: (N, F) -> (G, F)."""
    sums = segment.scatter_sum(x, graph_id, num_graphs, node_mask)
    cnt = segment.scatter_sum(node_mask, graph_id, num_graphs)
    return sums / torch.clamp(cnt, min=1.0)[:, None].to(x.dtype)


def node_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor, layout: GraphLayout | None = None
                 ) -> torch.Tensor:
    """The masked mean NLL; with ``layout`` this rank's rows' share of
    the global one (over the global mask's count)."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    count = mask.sum()
    if layout is not None:
        count = shd.all_reduce(count.detach(), layout.group, "gnn")
    return torch.sum(nll * mask) / torch.clamp(count, min=1.0)
