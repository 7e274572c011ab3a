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


def _unique_rows(edges: np.ndarray, n: int) -> np.ndarray:
    """``np.unique(edges, axis=0)`` for (E, 2) ids in [0, n), as int32:
    the distinct rows sorted by (src, dst), through one int64 key a row
    (a sort of integers, not of row records: the same rows in the same
    order, several times faster)."""
    key = np.unique(edges[:, 0].astype(np.int64) * n + edges[:, 1])
    return np.stack([key // n, key % n], axis=1).astype(np.int32)


def _random_edges(rng: np.random.Generator, n: int, m: int) -> np.ndarray:
    src = rng.integers(0, n, size=m, dtype=np.int64)
    dst = rng.integers(0, n, size=m, dtype=np.int64)
    return _unique_rows(np.stack([src, dst], axis=1), n)


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
        snaps.append(_unique_rows(np.concatenate([kept, fresh], axis=0),
                                  num_nodes))
    return snaps


def degree_features(edges: np.ndarray, num_nodes: int) -> np.ndarray:
    """(in-degree, out-degree) input features, as used by the paper (§6.1)."""
    f = np.zeros((num_nodes, 2), dtype=np.float32)
    # integer counts, exact in float32 (below 2^24): np.add.at's sums
    f[:, 0] = np.bincount(edges[:, 1], minlength=num_nodes)
    f[:, 1] = np.bincount(edges[:, 0], minlength=num_nodes)
    return f
