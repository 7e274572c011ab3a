"""Input-graph smoothing (paper §5.4): edge-life and M-transform.

Both are *host-side preprocessing* (the paper runs them once before training)
operating on ragged numpy edge lists, producing denser snapshots whose
consecutive-overlap the graph-difference transfer then exploits.  A copy
of ``repro.core.smoothing``, held byte-identical to it by
``tests/test_torch_train.py``.
"""

from __future__ import annotations

import numpy as np


def _merge(edge_sets: list[np.ndarray],
           weights: list[float]) -> tuple[np.ndarray, np.ndarray]:
    """Union of weighted edge lists with accumulation of duplicate weights."""
    all_edges = np.concatenate(edge_sets, axis=0)
    all_w = np.concatenate([np.full((e.shape[0],), w, dtype=np.float32)
                            for e, w in zip(edge_sets, weights, strict=True)])
    # Dedup on (src, dst), summing weights.
    key = all_edges[:, 0].astype(np.int64) * (all_edges.max() + 1 if
                                              all_edges.size else 1) \
        + all_edges[:, 1].astype(np.int64)
    # the first occurrence of each unique key (np.unique's index)
    uniq, first, inv = np.unique(key, return_index=True,
                                 return_inverse=True)
    w = np.zeros(uniq.shape[0], dtype=np.float32)
    np.add.at(w, inv, all_w)
    return all_edges[first].astype(np.int32), w


def edge_life(snapshots: list[np.ndarray], life: int
              ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """A_t <- A_t + sum_{i=t-l+1}^{t-1} A_i (EvolveGCN smoothing).

    Returns (edges, values) per snapshot; carried edges keep weight 1 per
    appearance (duplicates accumulate), matching the paper's formulation.
    """
    out_e, out_v = [], []
    for t in range(len(snapshots)):
        lo = max(0, t - life + 1)
        window = snapshots[lo:t + 1]
        e, v = _merge(window, [1.0] * len(window))
        out_e.append(e)
        out_v.append(v)
    return out_e, out_v


def m_transform_matrix(num_steps: int, window: int) -> np.ndarray:
    """The banded lower-triangular M of TM-GCN (§5.3), 1-indexed per paper:
    M[t, k] = 1 / min(w, t) for max(1, t - w + 1) <= k <= t."""
    m = np.zeros((num_steps, num_steps), dtype=np.float32)
    for t in range(1, num_steps + 1):
        lo = max(1, t - window + 1)
        for k in range(lo, t + 1):
            m[t - 1, k - 1] = 1.0 / min(window, t)
    return m


def m_transform_sparse(snapshots: list[np.ndarray], window: int
                       ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Apply the M-transform along the time mode of the sparse tensor A.

    hat(A)_t = sum_k M[t, k] A_k — a weighted union of the last w snapshots.
    """
    t_steps = len(snapshots)
    m = m_transform_matrix(t_steps, window)
    out_e, out_v = [], []
    for t in range(t_steps):
        ks = np.nonzero(m[t])[0]
        e, v = _merge([snapshots[k] for k in ks], [float(m[t, k]) for k in ks])
        out_e.append(e)
        out_v.append(v)
    return out_e, out_v
