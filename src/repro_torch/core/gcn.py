"""GCN spatial module (Kipf-Welling, Eq. 2) over padded snapshots.

Port of ``repro.core.gcn``.  The sparse-dense aggregate ``A_tilde @ X``
always goes through the segment-SpMM wrapper
(``repro_torch.kernels.segment_spmm``): on a CUDA tensor it launches the
CSR kernel, on a CPU tensor it runs the kernel's plain PyTorch version.
The device chooses, not a flag.  A caller that aggregates one snapshot in
several layers passes the snapshot's CSR (``spmm_ops.build_csr``) as
``csr`` and the wrapper does not build it again.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.segment_spmm import ops as spmm_ops


def init_gcn_params(gen: torch.Generator, f_in: int, f_out: int) -> dict:
    """{"w": U(-1/sqrt(f_in), 1/sqrt(f_in)) (f_in, f_out), "b": zeros}."""
    scale = 1.0 / f_in ** 0.5
    w = torch.rand((f_in, f_out), generator=gen) * (2 * scale) - scale
    return {"w": w, "b": torch.zeros((f_out,))}


def spatial_aggregate(x: torch.Tensor, edges: torch.Tensor,
                      edge_weights: torch.Tensor, num_nodes: int,
                      csr: tuple | None = None) -> torch.Tensor:
    """``A_tilde @ X`` for one snapshot. x: (N, F) -> (N, F).  ``csr`` is
    the snapshot's prebuilt (row_ptr, col, w), if the caller has it."""
    if csr is None:
        return spmm_ops.segment_spmm(x, edges, edge_weights, num_nodes)
    return spmm_ops.segment_spmm_csr(x.contiguous(), *csr)


def gcn_apply(params, x: torch.Tensor, edges: torch.Tensor,
              edge_weights: torch.Tensor, num_nodes: int, *,
              activation: Callable = torch.relu, concat_skip: bool = False,
              pre_aggregated: bool = False,
              csr: tuple | None = None) -> torch.Tensor:
    """One GCN op on one snapshot.

    concat_skip implements CD-GCN's skip connection (§5.1):
        Y0 = A_tilde X;  Y1 = Y0 W;  Y = act(concat(Y0, Y1))  (F + F' wide)
    pre_aggregated: x already equals A_tilde @ X (the paper's first-layer
    pre-computation, §5.5) — skip the sparse product.
    csr: the snapshot's prebuilt CSR, shared by the layers (see above).
    """
    y0 = x if pre_aggregated else spatial_aggregate(
        x, edges, edge_weights, num_nodes, csr)
    y1 = y0 @ params["w"] + params["b"]
    if concat_skip:
        return activation(torch.cat([y0, y1], dim=-1))
    return activation(y1)
