"""The state-advance forward shared by every consumer of the delta stream.

Port of the forward half of ``repro.stream.train_loop``: the device
reconstructs the padded edge list (``apply_delta``), appends self-loops,
recomputes the Laplacian weights from the reconstructed topology, and runs
the layer stack over a timeline slice, rolling the temporal carries.  The
serving engine runs it; the streamed per-snapshot trainer (loss + AdamW
over the delta stream, ``train_streamed``) waits for ROADMAP Queue 1,
item 6.  The blocked trainer over a padded batch is ``repro_torch.run``.
"""

from __future__ import annotations

import torch

from repro_torch.core import models as mdl
from repro_torch.graph import segment


def advance_slice(cfg: mdl.DynGNNConfig, params, carries: list,
                  frames: torch.Tensor, edges: torch.Tensor,
                  mask: torch.Tensor, values: torch.Tensor,
                  t_offset: int) -> tuple[torch.Tensor, list]:
    """One time-window of reconstructed snapshots rolls the temporal
    carries forward and yields the window's embeddings.

    frames (k, N, F), edges (k, E, 2), mask/values (k, E) -> (z (k, N, F'),
    new carries).  The serving engine (``serve.state.make_advance_step``)
    runs it once per closed window."""
    e_full, w_full = slice_weights_with_loops(
        cfg.num_nodes, *make_self_loops(cfg.num_nodes, edges.device),
        edges, mask, values)
    return mdl.forward_slice(cfg, params, frames, e_full, w_full, carries,
                             t_offset)


def make_self_loops(n: int, device=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Self-loop edge list (N, 2) int32 + unit mask/values (N,) for N nodes."""
    ids = torch.arange(n, dtype=torch.int32, device=device)
    return (torch.stack([ids, ids], dim=1),
            torch.ones((n,), dtype=torch.float32, device=device))


def slice_weights_with_loops(n: int, loop_edges: torch.Tensor,
                             loop_ones: torch.Tensor, edges: torch.Tensor,
                             mask: torch.Tensor, values: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Append self-loops to a (k, E, 2) slice of reconstructed snapshots
    and recompute the per-step Laplacian weights on the device ->
    (edges (k, E + N, 2), weights (k, E + N))."""
    k = edges.shape[0]
    e_full = torch.cat([edges, loop_edges.expand(k, -1, -1)], dim=1)
    m_full = torch.cat([mask, loop_ones.expand(k, -1)], dim=1)
    v_full = torch.cat([values, loop_ones.expand(k, -1)], dim=1)
    w_full = torch.stack([segment.gcn_edge_weights(e, n, m, v)
                          for e, m, v in zip(e_full, m_full, v_full,
                                             strict=True)])
    return e_full, w_full
