"""Discrete-Time Dynamic Graph (DTDG) batch containers.

Port of ``repro.core.dtdg``.  A DTDG (§2.1 of the paper) is a sequence of
T snapshots over a fixed vertex set of size N plus a feature frame per
step.  On the device everything is a static padded tensor:

  edges        (T, E_max, 2) int32 — (src, dst) per snapshot, padded
  edge_weights (T, E_max)    f32   — Laplacian-normalized (mask folded in)
  edge_mask    (T, E_max)    f32
  frames       (T, N, F)           — input features X

The host-side representation is a list of numpy edge arrays (ragged), which
is what the graph-difference transfer encoder consumes.  The padding is host
numpy (``graph.pad``); the Laplacian weights come from
``graph.segment.gcn_edge_weights`` on the batch's device.

A batch's topology never changes, so :meth:`DTDGBatch.csr_pairs` builds each
snapshot's forward and transposed CSR once (the aggregate ``A_tilde @ X``
and its gradient ``A_tilde^T @ dY``) and every later forward, recompute and
backward reads them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.graph import pad as padlib
from repro_torch.graph import segment
from repro_torch.kernels.segment_spmm import ops as spmm_ops


@dataclass
class DTDGBatch:
    edges: torch.Tensor          # (T, E, 2) int32
    edge_weights: torch.Tensor   # (T, E) f32 — normalized, mask folded in
    edge_mask: torch.Tensor      # (T, E) f32
    frames: torch.Tensor         # (T, N, F)
    num_nodes: int
    _csrs: list | None = field(default=None, repr=False, compare=False)

    @property
    def num_steps(self) -> int:
        return self.edges.shape[0]

    def csr_pairs(self) -> list:
        """[(forward CSR, transposed CSR)] per snapshot, built on the first
        call (2 T builds, counted by ``spmm_ops.csr_builds``, in one fenced
        ``train.csr_build`` span) and kept."""
        if self._csrs is None:
            with obs.span("train.csr_build", snapshots=self.num_steps) as sp:
                self._csrs = [spmm_ops.build_csr_pair(e, w, self.num_nodes)
                              for e, w in zip(self.edges, self.edge_weights,
                                              strict=True)]
                sp.fence(self._csrs[-1][1][0])
        return self._csrs


def build_batch(snapshots: list[np.ndarray], frames: np.ndarray,
                num_nodes: int, max_edges: int | None = None,
                add_self_loops: bool = True,
                values: list[np.ndarray] | None = None,
                device: str | torch.device = "cuda") -> DTDGBatch:
    """Pad host snapshots into a device-ready DTDG batch on ``device``.

    Laplacian normalization (Eq. 1) is pre-computed here per snapshot — it
    depends only on the topology, mirroring the paper's pre-computation of
    the first-layer spatial aggregate (§5.5).
    """
    dev = resolve_device(device)
    t_steps = len(snapshots)
    if max_edges is None:
        max_edges = max(s.shape[0] + (num_nodes if add_self_loops else 0)
                        for s in snapshots)
        max_edges = padlib.round_up(max_edges, 128)

    e_arr = np.zeros((t_steps, max_edges, 2), dtype=np.int32)
    v_arr = np.zeros((t_steps, max_edges), dtype=np.float32)
    m_arr = np.zeros((t_steps, max_edges), dtype=np.float32)
    for t, snap in enumerate(snapshots):
        vals = values[t] if values is not None else None
        if add_self_loops:
            snap, vals = padlib.add_self_loops(snap, num_nodes, vals)
        e_arr[t], v_arr[t], m_arr[t] = padlib.pad_edges(snap, max_edges,
                                                        vals)
    edges = torch.from_numpy(e_arr).to(dev)
    mask = torch.from_numpy(m_arr).to(dev)
    vals_t = torch.from_numpy(v_arr).to(dev)
    weights = torch.stack([segment.gcn_edge_weights(e, num_nodes, m, v)
                           for e, m, v in zip(edges, mask, vals_t,
                                              strict=True)])
    return DTDGBatch(edges=edges, edge_weights=weights, edge_mask=mask,
                     frames=torch.from_numpy(np.asarray(frames)).to(dev),
                     num_nodes=num_nodes)
