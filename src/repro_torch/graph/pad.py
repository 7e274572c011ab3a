"""Static-shape padding utilities (host numpy, a copy of ``repro.graph.pad``).

Real snapshots have varying edge counts; the batch pads edge lists to a
fixed ``max_edges`` and carries a mask.  Padded edges point at node 0 but
always carry weight 0 / mask 0, so they contribute nothing.  Held
byte-identical to the original by ``tests/test_torch_train.py``.
"""

from __future__ import annotations

import numpy as np


def pad_edges(edges: np.ndarray, max_edges: int,
              values: np.ndarray | None = None):
    """Pad an (E, 2) int array to (max_edges, 2); returns (edges, values, mask).

    Raises if E > max_edges: callers size max_edges from the dataset.
    """
    e = edges.shape[0]
    if e > max_edges:
        raise ValueError(f"edge count {e} exceeds max_edges {max_edges}")
    out = np.zeros((max_edges, 2), dtype=np.int32)
    out[:e] = edges
    mask = np.zeros((max_edges,), dtype=np.float32)
    mask[:e] = 1.0
    if values is None:
        values = np.ones((e,), dtype=np.float32)
    vals = np.zeros((max_edges,), dtype=np.float32)
    vals[:e] = values
    return out, vals, mask


def add_self_loops(edges: np.ndarray, num_nodes: int,
                   values: np.ndarray | None = None):
    """Append one self-loop per node (the ``A + I`` of Eq. 1)."""
    loops = np.stack([np.arange(num_nodes, dtype=np.int32)] * 2, axis=1)
    out = np.concatenate([edges.astype(np.int32), loops], axis=0)
    if values is not None:
        out_vals = np.concatenate(
            [values, np.ones((num_nodes,), dtype=values.dtype)])
        return out, out_vals
    return out, None


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple
