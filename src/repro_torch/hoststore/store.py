"""Host-resident temporal graph store (a copy of ``repro.hoststore.store``
on the port's own stream items and encoder).

``TemporalCSRStore`` keeps the WHOLE trace on host numpy — per-step
in-neighbor CSR adjacency plus edge values — so the device only ever
sees sampled, static-shape subgraphs (``hoststore.sampled``).  Host RAM
is the capacity axis here: a trace whose full per-snapshot tensors blow
the device budget still fits as a few numpy arrays per step.

Ingest is incremental and shares the device path's transfer protocol:
the store consumes the SAME ``FullSnapshot`` / ``SnapshotDelta`` items
the ``IncrementalEncoder`` emits (one encode of the trace, no second
decode), applying each delta to a host mirror with exactly the device
order ``graphdiff.apply_delta`` produces — survivors compacted in
order, adds appended.  The per-step CSR is then built once from the
mirrored edge list, with values re-gathered into CSR order so a sampled
edge's value rides along by CSR position.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graphdiff import FullSnapshot, SnapshotDelta
from repro_torch.graph.sampler import CSRGraph
from repro_torch.stream import encoder as enc


class TemporalCSRStore:
    """Per-step host CSR adjacency built from the delta stream.

    ``ingest(item)`` appends one step; ``csr(t)`` / ``values_csr(t)`` /
    ``edges(t)`` read it back.  ``indices``/``values`` are stored in CSR
    (dst-major) order: ``csr(t).indices[k]`` is the source of the k-th
    CSR entry and ``values_csr(t)[k]`` its edge value, so the sampler's
    ``edge_pos`` output indexes both.
    """

    def __init__(self, num_nodes: int):
        self.num_nodes = num_nodes
        self._indptr: list[np.ndarray] = []
        self._indices: list[np.ndarray] = []
        self._values: list[np.ndarray] = []
        # device-order mirror of the CURRENT step (what the next delta's
        # drop positions index) — exactly apply_delta's layout
        self._mirror_edges: np.ndarray | None = None

    # ------------------------------------------------------- ingest -------

    def ingest(self, item: FullSnapshot | SnapshotDelta) -> int:
        """Apply one encoder item; returns the step index it became."""
        if isinstance(item, FullSnapshot):
            edges = np.asarray(item.edges[:item.num_edges])
        elif isinstance(item, SnapshotDelta):
            if self._mirror_edges is None:
                raise ValueError("delta before any FullSnapshot — the "
                                 "stream must open with a full sync")
            prev = self._mirror_edges
            n_drop = int(item.drop_mask.sum())
            drop_pos = np.asarray(item.drop_pos[:n_drop], dtype=np.int64)
            keep = np.ones((prev.shape[0],), dtype=bool)
            keep[drop_pos] = False
            n_add = int(item.add_mask.sum())
            adds = np.asarray(item.add_edges[:n_add])
            edges = np.concatenate([prev[keep], adds], axis=0)
            if edges.shape[0] != item.num_edges:
                raise ValueError(
                    f"delta reconstruction mismatch at step "
                    f"{len(self._indptr)}: {edges.shape[0]} edges vs "
                    f"declared {item.num_edges}")
        else:
            raise TypeError(f"cannot ingest {type(item).__name__}")
        values = np.asarray(item.values[:item.num_edges], dtype=np.float32)
        self._mirror_edges = edges
        self._append_csr(edges, values)
        return len(self._indptr) - 1

    def _append_csr(self, edges: np.ndarray, values: np.ndarray) -> None:
        n = self.num_nodes
        if edges.shape[0]:
            order = np.argsort(edges[:, 1], kind="stable")
            dst_sorted = edges[order, 1].astype(np.int64)
            src_sorted = edges[order, 0].astype(np.int64)
            counts = np.bincount(dst_sorted, minlength=n)
            vals = values[order]
        else:
            src_sorted = np.zeros((0,), dtype=np.int64)
            counts = np.zeros((n,), dtype=np.int64)
            vals = np.zeros((0,), dtype=np.float32)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        self._indptr.append(indptr)
        self._indices.append(src_sorted)
        self._values.append(vals)

    @classmethod
    def from_stream(cls, items, num_nodes: int) -> "TemporalCSRStore":
        store = cls(num_nodes)
        for item in items:
            store.ingest(item)
        return store

    @classmethod
    def from_snapshots(cls, snapshots, values, num_nodes: int,
                       block_size: int,
                       stats: enc.DeltaStats | None = None
                       ) -> "TemporalCSRStore":
        """Encode-and-ingest: routes through ``iter_encode_stream`` so
        the store sees byte-identical items to the device path."""
        return cls.from_stream(
            enc.iter_encode_stream(snapshots, values, num_nodes,
                                   enc.padded_max_edges(snapshots),
                                   block_size, stats),
            num_nodes)

    # --------------------------------------------------------- reads ------

    @property
    def num_steps(self) -> int:
        return len(self._indptr)

    def csr(self, t: int) -> CSRGraph:
        return CSRGraph(indptr=self._indptr[t], indices=self._indices[t])

    def values_csr(self, t: int) -> np.ndarray:
        """Edge values aligned with ``csr(t).indices``."""
        return self._values[t]

    def edges(self, t: int) -> np.ndarray:
        """(E_t, 2) int64 (src, dst) in CSR order (dst-major)."""
        indptr, src = self._indptr[t], self._indices[t]
        dst = np.repeat(np.arange(self.num_nodes, dtype=np.int64),
                        np.diff(indptr))
        return np.stack([src, dst], axis=1)

    def max_in_degree(self) -> int:
        """Largest in-degree over all steps — the full-fanout threshold."""
        return max(int(np.diff(ip).max()) if ip[-1] else 0
                   for ip in self._indptr)

    @property
    def nbytes(self) -> int:
        """Host bytes the resident trace occupies."""
        return sum(a.nbytes for arrs in (self._indptr, self._indices,
                                         self._values) for a in arrs)
