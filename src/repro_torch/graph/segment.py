"""Segment-reduction message-passing primitives (port of ``repro.graph.segment``).

Degrees and the Laplacian edge weights, by scatter-add (``index_add_``)
into node rows.  The GCN aggregate ``A_tilde @ X`` itself (``spmm`` in the
JAX package) is ``repro_torch.kernels.segment_spmm``: the CUDA kernel on a
CUDA tensor, its plain version (``ref.py``) on a CPU tensor.

Conventions: ``edges`` is an int32 (E, 2) tensor of (src, dst) columns;
padded edges carry a zero in ``edge_mask`` / a zero weight, so results
never depend on pad contents.  The ``scatter_*`` family waits for the GNN
side workloads (ROADMAP Queue 1, item 9).
"""

from __future__ import annotations

import torch


def _degree(index: torch.Tensor, num_nodes: int,
            edge_mask: torch.Tensor | None) -> torch.Tensor:
    ones = torch.ones(index.shape[0], dtype=torch.float32,
                      device=index.device)
    if edge_mask is not None:
        ones = ones * edge_mask.to(torch.float32)
    out = torch.zeros(num_nodes, dtype=torch.float32, device=index.device)
    return out.index_add_(0, index.long(), ones)


def in_degree(edges: torch.Tensor, num_nodes: int,
              edge_mask: torch.Tensor | None = None) -> torch.Tensor:
    return _degree(edges[:, 1], num_nodes, edge_mask)


def out_degree(edges: torch.Tensor, num_nodes: int,
               edge_mask: torch.Tensor | None = None) -> torch.Tensor:
    return _degree(edges[:, 0], num_nodes, edge_mask)


def gcn_edge_weights(edges: torch.Tensor, num_nodes: int,
                     edge_mask: torch.Tensor | None = None,
                     edge_values: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """Symmetric-normalized Laplacian edge weights (Eq. 1 of the paper).

    w(u, v) = val(u, v) / sqrt((1 + deg_u) (1 + deg_v)); the "+1" is the
    identity (self-loop) term of ``A + I``.  Out-degree on the source,
    in-degree on the destination, as the JAX package does for directed
    snapshots.
    """
    inv_sqrt_in = torch.rsqrt(1.0 + in_degree(edges, num_nodes, edge_mask))
    inv_sqrt_out = torch.rsqrt(1.0 + out_degree(edges, num_nodes,
                                                edge_mask))
    w = inv_sqrt_out[edges[:, 0].long()] * inv_sqrt_in[edges[:, 1].long()]
    if edge_values is not None:
        w = w * edge_values
    if edge_mask is not None:
        w = w * edge_mask.to(w.dtype)
    return w
