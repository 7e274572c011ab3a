"""SchNet (arXiv:1706.08566): continuous-filter convolutions over 3D
positions.  Config: 3 interaction blocks, d_hidden=64, 300 RBF centers,
cutoff 10 A.

    interaction:  x_j -> W1 x_j ;  filter = MLP(rbf(d_ij)) (ssp act)
                  m_i = sum_j (W1 x_j) * filter(d_ij)
                  x_i += W3 ssp(W2 m_i)

ssp = shifted softplus.  Port of ``repro.models.gnn.schnet``; each block is
checkpointed under autograd.  ``F.softplus`` returns x above 20 where the
reference's is exact: they differ by less than 2.1e-9.  With a
``layout`` (``common.GraphLayout``) the batch is a rank's part of a full
graph: its edge lanes and its node rows (positions gathered whole).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.graph import segment
from repro_torch.models.gnn.common import (GraphBatch, GraphLayout,
                                           graph_readout)
from repro_torch.nn.layers import init_dense


def ssp(x: torch.Tensor) -> torch.Tensor:
    """Shifted softplus: log(0.5 e^x + 0.5)."""
    return F.softplus(x) - math.log(2.0)


def rbf_expand(dist: torch.Tensor, n_rbf: int, cutoff: float
               ) -> torch.Tensor:
    """Gaussian radial basis on [0, cutoff]: (E,) -> (E, n_rbf)."""
    centers = torch.linspace(0.0, cutoff, n_rbf, dtype=dist.dtype,
                             device=dist.device)
    gamma = 1.0 / ((cutoff / n_rbf) ** 2)
    return torch.exp(-gamma * (dist[:, None] - centers[None, :]) ** 2)


def init_params(gen: torch.Generator, d_in: int, d_hidden: int,
                n_interactions: int, n_rbf: int, num_classes: int,
                dtype=torch.float32) -> dict:
    def zeros():
        return torch.zeros((d_hidden,), dtype=dtype, device=gen.device)

    blocks = [{
        "w1": init_dense(gen, d_hidden, d_hidden, dtype),
        "filt1": init_dense(gen, n_rbf, d_hidden, dtype),
        "filt1_b": zeros(),
        "filt2": init_dense(gen, d_hidden, d_hidden, dtype),
        "filt2_b": zeros(),
        "w2": init_dense(gen, d_hidden, d_hidden, dtype),
        "w2_b": zeros(),
        "w3": init_dense(gen, d_hidden, d_hidden, dtype),
        "w3_b": zeros(),
    } for _ in range(n_interactions)]
    return {
        "embed": init_dense(gen, d_in, d_hidden, dtype),
        "blocks": blocks,
        "out1": init_dense(gen, d_hidden, d_hidden // 2, dtype),
        "out2": init_dense(gen, d_hidden // 2, num_classes, dtype),
    }


def forward(params, batch: GraphBatch, cutoff: float = 10.0,
            layout: GraphLayout | None = None) -> torch.Tensor:
    edges, emask = batch.edges, batch.edge_mask
    n = batch.node_feat.shape[0] if layout is None else layout.num_nodes
    group = None if layout is None else layout.group
    src, dst = edges[:, 0].long(), edges[:, 1].long()
    pos = batch.positions if layout is None else \
        layout.whole(batch.positions)
    diff = pos.index_select(0, src) - pos.index_select(0, dst)
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    n_rbf = params["blocks"][0]["filt1"].shape[0]
    rbf = rbf_expand(dist, n_rbf, cutoff)
    # smooth cosine cutoff envelope
    env = 0.5 * (torch.cos(math.pi * torch.clamp(dist / cutoff, 0, 1))
                 + 1.0)
    w_edge = (env * emask)[:, None]

    x = batch.node_feat @ params["embed"]

    def block(bp, x):
        filt = ssp(rbf @ bp["filt1"] + bp["filt1_b"])
        filt = ssp(filt @ bp["filt2"] + bp["filt2_b"]) * w_edge
        xw = x @ bp["w1"]
        if layout is not None:
            xw = layout.whole(xw)
        msgs = xw.index_select(0, src) * filt
        m = segment.scatter_sum(msgs, dst, n, group=group, rows=True)
        return x + (ssp(m @ bp["w2"] + bp["w2_b"]) @ bp["w3"] + bp["w3_b"])

    remat = torch.is_grad_enabled()
    for bp in params["blocks"]:
        x = checkpoint(block, bp, x, use_reentrant=False) if remat \
            else block(bp, x)
    return x


def logits(params, batch: GraphBatch, cutoff: float = 10.0,
           layout: GraphLayout | None = None) -> torch.Tensor:
    h = forward(params, batch, cutoff, layout)
    h = ssp(h @ params["out1"])
    if batch.graph_id is not None:
        h = graph_readout(h, batch.graph_id, batch.num_graphs,
                          batch.node_mask)
    return h @ params["out2"]
