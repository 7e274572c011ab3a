"""Dynamic-graph data pipeline (port of ``repro.data.dyngnn``).

Host-side stages (the CPU side of the paper's CPU -> GPU boundary):
  1. snapshot generation / loading (ragged numpy edge lists),
  2. smoothing (edge-life / M-transform) — §5.4 preprocessing,
  3. graph-difference delta encoding per checkpoint block (§3.2),
  4. padding + Laplacian normalization -> a device-ready DTDG batch,
  5. label synthesis for vertex classification / link prediction tasks.

Stages 1–3 and 5 are host numpy, copies of the reference's; the batch
(stage 4) lands on the pipeline's device.  Under snapshot partitioning a
rank moves only its own steps there (``rank_batch`` / ``rank_arrays``),
and the distributed stream encodes only its own time slices
(``sharded_streams(..., rank=r)``).
``transfer_bytes()`` reports the graph-difference savings.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import graphdiff, smoothing
from repro_torch.core.dtdg import DTDGBatch, build_batch
from repro_torch.graph import generate
from repro_torch.stream import encoder as stream_encoder
from repro_torch.stream import sharded as stream_sharded


@dataclass
class DTDGDataset:
    snapshots: list[np.ndarray]
    values: list[np.ndarray] | None
    frames: np.ndarray              # (T, N, F)
    labels: np.ndarray              # (T, N)
    num_nodes: int

    @property
    def num_steps(self) -> int:
        return len(self.snapshots)


def dataset_from_snapshots(snaps: list[np.ndarray], num_nodes: int,
                           smoothing_mode: str = "none", window: int = 5,
                           edge_life: int = 5) -> DTDGDataset:
    """Raw snapshot edge lists -> DTDG dataset: smoothing (§5.4) -> degree
    features -> synthetic labels.

    smoothing_mode: none (CD-GCN) | mproduct (TM-GCN) | edgelife (EvolveGCN).
    """
    values = None
    if smoothing_mode == "mproduct":
        snaps, values = smoothing.m_transform_sparse(snaps, window)
    elif smoothing_mode == "edgelife":
        snaps, values = smoothing.edge_life(snaps, edge_life)
    elif smoothing_mode != "none":
        raise ValueError(f"unknown smoothing_mode {smoothing_mode!r}")
    frames = np.stack([generate.degree_features(s, num_nodes)
                       for s in snaps])
    # synthetic-but-learnable labels: high in-degree (above median) = class 1
    med = np.median(frames[:, :, 0], axis=1, keepdims=True)
    labels = (frames[:, :, 0] > med).astype(np.int32)
    return DTDGDataset(snapshots=snaps, values=values, frames=frames,
                       labels=labels, num_nodes=num_nodes)


def synthetic_dataset(num_nodes: int, num_steps: int, density: float = 3.0,
                      churn: float = 0.1, smoothing_mode: str = "none",
                      window: int = 5, edge_life: int = 5,
                      seed: int = 0) -> DTDGDataset:
    """Evolving synthetic DTDG with degree features and synthetic labels."""
    snaps = generate.evolving_dynamic_graph(num_nodes, num_steps, density,
                                            churn, seed)
    return dataset_from_snapshots(snaps, num_nodes,
                                  smoothing_mode=smoothing_mode,
                                  window=window, edge_life=edge_life)


class DTDGPipeline:
    def __init__(self, ds: DTDGDataset, nb: int, max_edges: int | None = None,
                 device: str | torch.device = "cuda"):
        self.ds = ds
        self.nb = nb
        self.bsize = ds.num_steps // nb
        self.device = device
        loops = ds.num_nodes
        if max_edges is None:
            max_edges = max(s.shape[0] for s in ds.snapshots) + loops
            max_edges = ((max_edges + 127) // 128) * 128
        self.max_edges = max_edges
        self._batch = None
        self._rank = None               # (layout, its DTDGBatch)
        # only the byte total is kept: host_stream re-encodes lazily
        self.stream_stats = stream_encoder.measure_stats(
            ds.snapshots, ds.num_nodes, self.bsize, max_edges)
        self._stream_bytes = sum(
            item.payload_bytes for item in self.host_stream())

    @property
    def batch(self) -> DTDGBatch:
        """The padded batch on the pipeline's device (precomputed Laplacian
        weights, §5.5), built on first access."""
        if self._batch is None:
            self._batch = build_batch(self.ds.snapshots, self.ds.frames,
                                      self.ds.num_nodes,
                                      max_edges=self.max_edges,
                                      values=self.ds.values,
                                      device=self.device)
        return self._batch

    def transfer_bytes(self) -> dict:
        gd = self._stream_bytes
        base = graphdiff.naive_bytes(self.ds.snapshots)
        return {"graph_diff": gd, "naive": base,
                "ratio": gd / max(base, 1)}

    def host_stream(self):
        """Lazy re-encode of the trace (what a prefetch thread drains)."""
        return stream_encoder.iter_encode_stream(
            self.ds.snapshots, self.ds.values, self.ds.num_nodes,
            self.max_edges, self.bsize, self.stream_stats)

    def sharded_streams(self, num_shards: int, wire: str = "none",
                        rank: int | None = None):
        """Per-shard time-slice streams of the snapshot-parallel stream
        (``wire="int8"`` = the narrow delta format, see ``stream.wire``):
        every shard's, or only shard ``rank``'s (a list of one stream), as
        a rank process encodes its own."""
        return stream_sharded.encode_time_sliced(
            self.ds.snapshots, self.ds.values, self.ds.num_nodes,
            self.max_edges, self.bsize, num_shards, self.stream_stats,
            wire=wire, shards=None if rank is None else [rank])

    def rank_batch(self, layout) -> DTDGBatch:
        """One rank's steps (``layout.steps``, a ``dist.sharding.
        ShardLayout``, block by block) as a padded batch on the pipeline's
        device, built on first call: the full batch's padding and Laplacian
        weights for those steps, and nothing of the other ranks' steps.
        Its ``csr_pairs()`` are the rank's own snapshots'."""
        if self._rank is None or self._rank[0] != layout:
            steps = layout.steps
            vals = self.ds.values
            self._rank = (layout, build_batch(
                [self.ds.snapshots[t] for t in steps],
                self.ds.frames[steps], self.ds.num_nodes,
                max_edges=self.max_edges,
                values=None if vals is None else [vals[t] for t in steps],
                device=self.device))
        return self._rank[1]

    def rank_arrays(self, layout):
        """(frames, edges, edge_weights, labels) of one rank, blocked
        (nb, bsl, ...): views of :meth:`rank_batch`, and its labels."""
        b = self.rank_batch(layout)
        labels = torch.from_numpy(self.ds.labels[layout.steps]).to(
            b.frames.device)
        return tuple(a.reshape((layout.nb, layout.bsl) + tuple(a.shape[1:]))
                     for a in (b.frames, b.edges, b.edge_weights, labels))

    def blocked_arrays(self):
        """(frames, edges, edge_weights, labels) blocked (nb, bsize, ...)."""
        def blk(a):
            t = a.shape[0]
            return a.reshape((self.nb, t // self.nb) + tuple(a.shape[1:]))

        b = self.batch
        labels = torch.from_numpy(self.ds.labels).to(b.frames.device)
        return (blk(b.frames), blk(b.edges), blk(b.edge_weights),
                blk(labels))
