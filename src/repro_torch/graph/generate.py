"""Synthetic graph generators (host numpy).

A copy of ``repro.graph.generate`` kept byte-identical by
``tests/test_torch_stream.py``: ``degree_features`` builds the serving
path's per-window input frame, and the dynamic-graph generators feed the
port's tests.  Both return plain numpy edge lists (list of (E_t, 2) int32
arrays): the dynamic graph lives on the host and is shipped to the device
as graph differences.
"""

from __future__ import annotations

import numpy as np


def _random_edges(rng: np.random.Generator, n: int, m: int) -> np.ndarray:
    src = rng.integers(0, n, size=m, dtype=np.int64)
    dst = rng.integers(0, n, size=m, dtype=np.int64)
    edges = np.stack([src, dst], axis=1)
    return np.unique(edges, axis=0).astype(np.int32)


def random_dynamic_graph(num_nodes: int, num_steps: int, density: float,
                         seed: int = 0) -> list[np.ndarray]:
    """Independent random snapshots with ``N * density`` edges each."""
    rng = np.random.default_rng(seed)
    m = int(num_nodes * density)
    return [_random_edges(rng, num_nodes, m) for _ in range(num_steps)]


def evolving_dynamic_graph(num_nodes: int, num_steps: int, density: float,
                           churn: float = 0.1, seed: int = 0
                           ) -> list[np.ndarray]:
    """Snapshot t+1 keeps a (1 - churn) fraction of snapshot t's edges."""
    rng = np.random.default_rng(seed)
    m = int(num_nodes * density)
    snaps = [_random_edges(rng, num_nodes, m)]
    for _ in range(1, num_steps):
        prev = snaps[-1]
        keep = rng.random(prev.shape[0]) >= churn
        kept = prev[keep]
        fresh = _random_edges(rng, num_nodes, max(m - kept.shape[0], 0))
        nxt = np.unique(np.concatenate([kept, fresh], axis=0), axis=0)
        snaps.append(nxt.astype(np.int32))
    return snaps


def degree_features(edges: np.ndarray, num_nodes: int) -> np.ndarray:
    """(in-degree, out-degree) input features, as used by the paper (§6.1)."""
    f = np.zeros((num_nodes, 2), dtype=np.float32)
    np.add.at(f[:, 0], edges[:, 1], 1.0)
    np.add.at(f[:, 1], edges[:, 0], 1.0)
    return f
