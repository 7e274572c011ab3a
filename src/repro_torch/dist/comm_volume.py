"""Analytic communication-volume models (paper §4 / Table 2).

Port of ``repro.dist.comm_volume``: the pure-numpy laws, copied (their
outputs are pinned equal to the reference's by
``tests/test_torch_partition.py``).  Volumes are counted in FLOAT UNITS
actually crossing the network (the (P-1)/P locality discount of tiled
collectives is applied), summed over all processors — the quantity the
paper tabulates.

* ``snapshot_partition_volume`` — the paper's scheme: two all-to-alls per
  GCN layer redistributing the full (T, N, F) activation tensor, so the
  total is O(T*N*F*L) for ANY processor count.  EvolveGCN's temporal op
  acts on the (tiny) layer weights, so its feature path is
  communication-free (§5.5).
* ``allgather_vertex_volume`` — the regular upper bound of vertex
  partitioning: every layer all-gathers the frame, volume grows ~P.
* ``vertex_partition_volume`` — the hypergraph (λ-1 cut) estimate for a
  GIVEN vertex-ownership vector: each (boundary vertex, remote partition)
  pair ships one F-float feature row per layer per snapshot.
* ``bfs_partition`` — BFS-locality ownership standing in for PaToH:
  contiguity-aware equal-size partitions so the cut metric is meaningful.

The reference's ``hlo_collective_bytes`` (a parser of XLA's HLO text) has
no counterpart: the port counts the bytes it hands to each all-to-all
itself (``repro_torch.dist.sharding``: the ``partition.a2a_bytes``,
``partition.a2a_remote_bytes`` and ``partition.a2a_calls`` counters).
"""

from __future__ import annotations

from collections import deque

import numpy as np


def snapshot_partition_volume(t: int, n: int, feat: int, layers: int,
                              p: int, model: str = "tmgcn") -> float:
    """Total float units moved per epoch under snapshot partitioning."""
    if model == "evolvegcn":
        # weights-evolve models redistribute nothing on the feature path;
        # only the per-block boundary weight broadcast remains (negligible
        # but nonzero so ratios stay defined).
        return float(layers * feat * feat * max(p - 1, 0))
    if p <= 1:
        return 0.0
    # 2 all-to-alls per layer, each moving (P-1)/P of the (T, N, F) tensor.
    return 2.0 * layers * t * n * feat * (p - 1) / p


def alltoall_round_payload(win: int, n: int, feat: int, layers: int,
                           p: int, bytes_per: float = 4.0,
                           compression: str = "none",
                           a2a_chunks: int = 1) -> float:
    """Bytes crossing the network in ONE streamed round of ``win``
    snapshots under snapshot partitioning: two all-to-alls per GCN layer
    over the (win, N, F) block, each moving the (P-1)/P off-device
    fraction.  Per SNAPSHOT this approaches 2*L*N*F*bytes_per from below
    as P grows — the fixed-volume property the streamed distributed
    trainer inherits (total communication independent of P).

    ``compression`` != "none" models the int8 quantized redistributions
    (the reference's ``dist.compression``; ROADMAP Queue 1, item 7 ports
    it): one byte per element plus
    one (P,) f32 scale vector per all-to-all per shard — and each of the
    2L redistributions lowers to ``a2a_chunks`` feature-sliced
    all-to-alls, so the scale overhead grows with the chunk count while
    the element payload does not.
    """
    if p <= 1:
        return 0.0
    elems = 2.0 * layers * win * n * feat * (p - 1) / p
    if compression == "none":
        return elems * bytes_per
    # int8 payload + the per-chunk scale a2a: each of the 2L*chunks
    # quantized all-to-alls ships a (P,) f32 scale vector per shard, of
    # which (P-1) entries cross the network; P shards total.
    scale_bytes = 2.0 * layers * a2a_chunks * p * (p - 1) * 4.0
    return elems * 1.0 + scale_bytes


def index_width(max_index: int) -> float:
    """Wire bytes per index under stream.wire narrowing (int16 when the
    largest index fits, int32 otherwise)."""
    return 2.0 if max_index <= 32767 else 4.0


def delta_wire_bytes(drops: float, adds: float, num_edges: float, *,
                     num_nodes: int, max_edges: int,
                     wire: str = "none") -> float:
    """Bytes of one delta payload, mirroring the per-item accounting of
    ``SnapshotDelta.payload_bytes`` (f32 wire) and
    ``stream.wire.QuantizedDelta.payload_bytes`` (int8 wire): drop
    positions index the device edge list, adds carry two node ids, one
    value per valid edge, plus the f32 scale on the quantized wire."""
    if wire == "none":
        return drops * 4.0 + adds * 8.0 + num_edges * 4.0
    if wire != "int8":
        raise ValueError(f"wire must be none|int8, got {wire!r}")
    return (drops * index_width(max_edges - 1)
            + adds * 2.0 * index_width(num_nodes - 1)
            + num_edges * 1.0 + 4.0)


def streamed_shard_volume(num_steps: int, p: int, block_size: int,
                          bytes_full: float, bytes_delta: float) -> float:
    """Analytic per-shard host->device stream bytes under the time-sliced
    delta streams (stream/sharded.py): each shard opens every round
    (= checkpoint block) with one self-contained full snapshot — the
    per-shard analogue of the block-boundary rule — and ships deltas for
    the rest of its ``num_steps/P`` owned slice.

    Under time-axis weak scaling (T and block_size grown with P, per-shard
    work fixed) this is CONSTANT in P; on a fixed trace it shrinks ~1/P.
    """
    owned = num_steps / p
    fulls = num_steps / block_size          # one slice start per block
    return fulls * bytes_full + max(owned - fulls, 0.0) * bytes_delta


def rescale_payload(carry_bytes: float, state_bytes: float, old_p: int,
                    new_p: int) -> float:
    """Bytes crossing the links at ONE elastic rescale P_old -> P_new
    (``repro.elastic``): the vertex-sharded temporal carries are re-laid
    out over the new mesh (one gather/scatter of the full carry tree),
    and — only when the mesh GROWS — the replicated train state (params +
    optimizer) is shipped once to each newly added device.  Shrinking
    moves no replicas: the surviving devices already hold them.

    The total is O(model state + block-boundary carries), independent of
    T and of the stream volume — the reason elasticity is cheap under
    fixed-volume snapshot partitioning: changing P re-blocks the
    timeline and re-slices the delta streams, but the O(T*N) transfer
    volume itself is the same at any P, so only boundary state moves.
    """
    if old_p < 1 or new_p < 1:
        raise ValueError(f"processor counts must be >= 1, got "
                         f"{old_p} -> {new_p}")
    if old_p == new_p:
        return 0.0
    return float(carry_bytes) + max(new_p - old_p, 0) * float(state_bytes)


def allgather_vertex_volume(t: int, n: int, feat: int, layers: int,
                            p: int) -> float:
    """Regular-pattern vertex baseline: per layer & snapshot every
    processor receives the (P-1)/P remote rows of the (N, F) frame."""
    if p <= 1:
        return 0.0
    return float(layers) * t * p * (n * (p - 1) / p) * feat


def bfs_partition(edges: np.ndarray, num_nodes: int, p: int) -> np.ndarray:
    """Equal-size BFS-locality vertex partitioning (PaToH stand-in).

    Grows partition 0..p-1 by BFS from unassigned seed vertices so each
    owns ``ceil(N/P)`` vertices; neighbours tend to share an owner, which
    is all the cut model needs.  Returns owner (N,) int32.
    """
    cap = -(-num_nodes // p)
    adj: list[list[int]] = [[] for _ in range(num_nodes)]
    for u, v in np.asarray(edges, dtype=np.int64):
        adj[u].append(int(v))
        adj[v].append(int(u))
    owner = np.full((num_nodes,), -1, dtype=np.int32)
    sizes = np.zeros((p,), dtype=np.int64)
    cur = 0
    for seed in range(num_nodes):
        if owner[seed] >= 0:
            continue
        q = deque([seed])
        while q:
            u = q.popleft()
            if owner[u] >= 0:
                continue
            while sizes[cur] >= cap and cur < p - 1:
                cur += 1
            owner[u] = cur
            sizes[cur] += 1
            for w in adj[u]:
                if owner[w] < 0:
                    q.append(w)
    return owner


def vertex_partition_volume(snapshots: list[np.ndarray], _n: int, feat: int,
                            layers: int, p: int,
                            owner: np.ndarray) -> float:
    """Hypergraph-style volume: λ-1 cut of the given ownership, per layer
    and snapshot, F floats per (vertex, remote partition) pair."""
    owner = np.asarray(owner)
    pairs = 0
    for snap in snapshots:
        e = np.asarray(snap, dtype=np.int64)
        if e.shape[0] == 0:
            continue
        src_own = owner[e[:, 0]]
        dst_own = owner[e[:, 1]]
        cut = src_own != dst_own
        if not cut.any():
            continue
        # distinct (src vertex, dst partition) pairs = rows shipped
        key = e[cut, 0] * p + dst_own[cut]
        pairs += np.unique(key).shape[0]
    return float(layers) * feat * pairs
