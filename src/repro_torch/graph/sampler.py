"""Host-side layered neighbor sampler (GraphSAGE-style fanout sampling).

Host numpy, a copy of ``repro.graph.sampler``, held byte-identical to it
(the same picks for the same generator) by ``tests/test_torch_hoststore.py``.
Uniform fanout sampling from a CSR adjacency produces fixed-size padded
subgraph tensors; sampling runs on host numpy (a data-pipeline stage),
and the device only ever sees static shapes.

Output layout per layer l (hop l from the seeds):
  * edges[l]: (batch * prod(fanouts[:l+1]), 2) int32 (src, dst) pairs indexed
    into the *local* node table,
  * node_ids: (num_sampled,) global ids of every sampled node (seeds first),
  * masks for padded lanes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CSRGraph:
    indptr: np.ndarray   # (N + 1,)
    indices: np.ndarray  # (nnz,)

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @staticmethod
    def from_edges(edges: np.ndarray, num_nodes: int) -> "CSRGraph":
        # CSR over incoming edges: row = dst, entries = srcs (we aggregate
        # messages into dst, so sampling expands the in-neighborhood).
        order = np.argsort(edges[:, 1], kind="stable")
        dst_sorted = edges[order, 1]
        src_sorted = edges[order, 0]
        counts = np.bincount(dst_sorted, minlength=num_nodes)
        indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSRGraph(indptr=indptr, indices=src_sorted.astype(np.int64))


@dataclass
class SampledBlock:
    """One hop of a layered sample, in local (renumbered) ids."""
    edges: np.ndarray       # (E_pad, 2) int32 local (src, dst)
    edge_mask: np.ndarray   # (E_pad,) float32
    edge_pos: np.ndarray | None = None  # (E_pad,) int64 CSR positions


@dataclass
class SampledSubgraph:
    node_ids: np.ndarray        # (N_pad,) int64 global ids, seeds first
    node_mask: np.ndarray       # (N_pad,) float32
    num_seeds: int
    blocks: list[SampledBlock]  # outermost hop first

    @property
    def num_nodes(self) -> int:
        return self.node_ids.shape[0]


def sample_neighbors(graph: CSRGraph, seeds: np.ndarray, fanouts: list[int],
                     rng: np.random.Generator) -> SampledSubgraph:
    """Layered uniform sampling with static padded output shapes."""
    seeds = np.asarray(seeds, dtype=np.int64)
    b = seeds.shape[0]

    # Global-id -> local-id table built incrementally; seeds occupy [0, b).
    local: dict[int, int] = {int(g): i for i, g in enumerate(seeds)}
    order: list[int] = list(map(int, seeds))

    frontier = seeds
    raw_blocks: list[np.ndarray] = []
    max_edges_per_layer: list[int] = []
    cap = b
    for f in fanouts:
        cap *= f
        max_edges_per_layer.append(cap)

    raw_pos: list[np.ndarray] = []
    for fanout in fanouts:
        srcs, dsts, poss = [], [], []
        for v in frontier:
            lo, hi = graph.indptr[v], graph.indptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            k = min(fanout, deg)
            picks = rng.choice(deg, size=k, replace=False) + lo
            for p, s in zip(picks, graph.indices[picks], strict=True):
                s = int(s)
                if s not in local:
                    local[s] = len(order)
                    order.append(s)
                srcs.append(local[s])
                dsts.append(local[int(v)])
                poss.append(int(p))
        edges = (np.stack([np.asarray(srcs, dtype=np.int32),
                           np.asarray(dsts, dtype=np.int32)], axis=1)
                 if srcs else np.zeros((0, 2), dtype=np.int32))
        raw_blocks.append(edges)
        raw_pos.append(np.asarray(poss, dtype=np.int64))
        frontier = np.asarray([order[i] for i in
                               np.unique(edges[:, 0])] if edges.size else [],
                              dtype=np.int64)

    # Static padded shapes: nodes padded to the worst-case closed neighborhood
    # (every sampled edge could introduce a new node).
    n_pad = b + sum(max_edges_per_layer)
    node_ids = np.zeros((n_pad,), dtype=np.int64)
    node_mask = np.zeros((n_pad,), dtype=np.float32)
    node_ids[:len(order)] = np.asarray(order, dtype=np.int64)
    node_mask[:len(order)] = 1.0

    blocks = []
    for edges, pos, cap in zip(raw_blocks, raw_pos, max_edges_per_layer,
                               strict=True):
        e_pad = np.zeros((cap, 2), dtype=np.int32)
        m = np.zeros((cap,), dtype=np.float32)
        p_pad = np.zeros((cap,), dtype=np.int64)
        e = min(edges.shape[0], cap)
        e_pad[:e] = edges[:e]
        m[:e] = 1.0
        p_pad[:e] = pos[:e]
        blocks.append(SampledBlock(edges=e_pad, edge_mask=m, edge_pos=p_pad))

    return SampledSubgraph(node_ids=node_ids, node_mask=node_mask,
                           num_seeds=b, blocks=blocks)


def flat_edges(sub: SampledSubgraph) -> tuple[np.ndarray, np.ndarray]:
    """Union of all hop blocks as one padded edge list (for flat GNN stacks)."""
    edges = np.concatenate([blk.edges for blk in sub.blocks], axis=0)
    mask = np.concatenate([blk.edge_mask for blk in sub.blocks], axis=0)
    return edges, mask
