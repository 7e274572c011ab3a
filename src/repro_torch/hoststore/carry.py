"""Host-resident per-node temporal state for the sampled schedule (port of
``repro.hoststore.carry``).

The full-graph schedules keep temporal carries (LSTM states, TM-GCN
window buffers) device-resident between rounds — O(N) device memory.
Out of core, N is exactly what does not fit, so the carries live here on
host numpy and each round only round-trips the rows of its sampled node
table: ``gather`` lifts table rows into ``table_pad``-row host arrays
(the caller ships its lanes to the device), ``scatter`` takes the
post-round rows — the port's tensors, on any device — to the host and
writes them back.

Nodes absent from a round's table simply keep their previous state —
with full-fanout sampling (every vertex a seed) every row updates every
round and the schedule is numerically the full-graph path.

EvolveGCN is the exception that proves the layout: its carry is a
weight matrix + weight-LSTM state (not per-node, §5.5), so it rides
whole — gathered and scattered as-is.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import models as mdl


def node_axis(cfg: mdl.DynGNNConfig) -> int | None:
    """Axis of the node dimension in one layer's carry leaves
    (None = the carry is not per-node and rides whole)."""
    if cfg.model == "cdgcn":
        return 0        # LSTM (h, c), each (N, d)
    if cfg.model == "evolvegcn":
        return None     # (W, (h, c)) — weight-evolution state
    if cfg.model == "tmgcn":
        return 1        # (window-1, N, d)
    raise ValueError(cfg.model)


def leaves(carry) -> list:
    """Flatten one layer's carry into its leaves (tuples only — the
    carry trees are nested tuples)."""
    if isinstance(carry, tuple):
        out = []
        for c in carry:
            out.extend(leaves(c))
        return out
    return [carry]


def rebuild(template, flat):
    """Inverse of :func:`leaves` against ``template``'s structure ->
    (tree, the leaves left over)."""
    if isinstance(template, tuple):
        parts = []
        for c in template:
            part, flat = rebuild(c, flat)
            parts.append(part)
        return tuple(parts), flat
    return flat[0], flat[1:]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class HostCarryStore:
    """Full-N temporal carries on host numpy, gathered per round.

    ``reset(params)`` re-derives the epoch-start state from the CURRENT
    params (EvolveGCN's initial weight carry is a copy of ``w0``, as
    ``models.init_carries`` aliases it at the top of every epoch).
    """

    def __init__(self, cfg: mdl.DynGNNConfig, params):
        self.cfg = cfg
        self.axis = node_axis(cfg)
        self._layers: list[list[np.ndarray]] = []
        self._templates: list = []
        self.reset(params)

    def reset(self, params) -> None:
        carries = mdl.init_carries(self.cfg, params)
        self._templates = carries
        # np.array (a copy): scatter() writes these in place, and
        # EvolveGCN's w0 leaf is the parameter itself
        self._layers = [[np.array(_host(leaf)) for leaf in leaves(c)]
                        for c in carries]

    # ------------------------------------------------------- gather -------

    def gather(self, node_ids: np.ndarray, table_pad: int) -> list:
        """Rows of ``node_ids`` lifted into ``table_pad``-sized host
        arrays (invalid lanes zero), in ``init_carries`` structure."""
        node_ids = np.asarray(node_ids, dtype=np.int64)
        k = node_ids.shape[0]
        ax = self.axis
        out = []
        for template, layer in zip(self._templates, self._layers,
                                   strict=True):
            if ax is None:
                rows = list(layer)
            else:
                rows = []
                for leaf in layer:
                    shape = list(leaf.shape)
                    shape[ax] = table_pad
                    buf = np.zeros(shape, dtype=leaf.dtype)
                    if ax == 0:
                        buf[:k] = leaf[node_ids]
                    else:
                        buf[:, :k] = leaf[:, node_ids]
                    rows.append(buf)
            tree, rest = rebuild(template, rows)
            if rest:
                raise ValueError("carry leaf mismatch")
            out.append(tree)
        return out

    # ------------------------------------------------------ scatter -------

    def scatter(self, node_ids: np.ndarray, new_carries: list) -> None:
        """Write the first ``len(node_ids)`` table rows of the post-round
        carries (tensors on any device, or arrays) back into the resident
        state (pad lanes discarded)."""
        node_ids = np.asarray(node_ids, dtype=np.int64)
        k = node_ids.shape[0]
        ax = self.axis
        for layer, new in zip(self._layers, new_carries, strict=True):
            for leaf, fresh in zip(layer, leaves(new), strict=True):
                fresh = _host(fresh)
                if ax is None:
                    leaf[...] = fresh
                elif ax == 0:
                    leaf[node_ids] = fresh[:k]
                else:
                    leaf[:, node_ids] = fresh[:, :k]

    def arrays(self) -> list[list[np.ndarray]]:
        """The resident state, layer by layer (the arrays themselves)."""
        return self._layers

    @property
    def nbytes(self) -> int:
        return sum(leaf.nbytes for layer in self._layers for leaf in layer)
