"""GatedGCN (Bresson & Laurent, arXiv:1711.07553; benchmarking-gnns config:
16 layers, d_hidden=70, gated aggregation, residual, LayerNorm).

    e_ij' = A h_i + B h_j + C e_ij
    eta_ij = sigma(e_ij') / (sum_{j'} sigma(e_ij') + eps)
    h_i'  = h_i + ReLU(LN(U h_i + sum_j eta_ij * (V h_j)))
    e_ij  = e_ij + ReLU(LN(e_ij'))

Port of ``repro.models.gnn.gatedgcn`` (LayerNorm in place of the paper's
BatchNorm, as there).  ``params`` is the reference's tree, as nested dicts
or a ``ParamTree``; each layer is checkpointed under autograd
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).  With a
``layout`` (``common.GraphLayout``) the batch is a rank's part of a full
graph: its edge lanes and its node rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.graph import segment
from repro_torch.models.gnn.common import (GraphBatch, GraphLayout,
                                           graph_readout)
from repro_torch.nn.layers import init_dense


def init_params(gen: torch.Generator, d_in: int, d_hidden: int,
                n_layers: int, num_classes: int,
                dtype=torch.float32) -> dict:
    dev = gen.device
    layers = [{
        **{k: init_dense(gen, d_hidden, d_hidden, dtype) for k in "ABCUV"},
        "ln_h_w": torch.ones((d_hidden,), dtype=dtype, device=dev),
        "ln_h_b": torch.zeros((d_hidden,), dtype=dtype, device=dev),
        "ln_e_w": torch.ones((d_hidden,), dtype=dtype, device=dev),
        "ln_e_b": torch.zeros((d_hidden,), dtype=dtype, device=dev),
    } for _ in range(n_layers)]
    return {
        "embed_h": init_dense(gen, d_in, d_hidden, dtype),
        # no input edge features
        "embed_e": torch.zeros((1, d_hidden), dtype=dtype, device=dev),
        "layers": layers,
        "out": init_dense(gen, d_hidden, num_classes, dtype),
    }


def forward(params, batch: GraphBatch, remat: bool = True,
            layout: GraphLayout | None = None) -> torch.Tensor:
    """Node embeddings (N, d_hidden); the caller applies ``params['out']``.

    ``remat``: per-layer activation checkpointing -- the (E, d) edge
    intermediates dominate memory on dense graphs, so only one layer's
    worth stays live.
    """
    emask = batch.edge_mask
    n = batch.node_feat.shape[0] if layout is None else layout.num_nodes
    group = None if layout is None else layout.group
    src, dst = batch.edges[:, 0].long(), batch.edges[:, 1].long()
    h = batch.node_feat @ params["embed_h"]
    e = params["embed_e"].expand(src.shape[0], -1)

    def layer(lp, h, e):
        d = h.shape[-1]
        whole = h if layout is None else layout.whole(h)
        h_src = whole.index_select(0, src)
        h_dst = whole.index_select(0, dst)
        e_hat = h_dst @ lp["A"] + h_src @ lp["B"] + e @ lp["C"]
        gate = torch.sigmoid(e_hat) * emask[:, None]
        denom = segment.scatter_sum(gate, dst, n, group=group)
        eta = gate / (denom.index_select(0, dst) + 1e-6)
        agg = segment.scatter_sum(eta * (h_src @ lp["V"]), dst, n,
                                  group=group, rows=True)
        h = h + F.relu(F.layer_norm(h @ lp["U"] + agg, (d,), lp["ln_h_w"],
                                    lp["ln_h_b"], 1e-5))
        e = e + F.relu(F.layer_norm(e_hat, (d,), lp["ln_e_w"],
                                    lp["ln_e_b"], 1e-5))
        return h, e

    remat = remat and torch.is_grad_enabled()
    for lp in params["layers"]:
        if remat:
            h, e = checkpoint(layer, lp, h, e, use_reentrant=False)
        else:
            h, e = layer(lp, h, e)
    return h


def logits(params, batch: GraphBatch,
           layout: GraphLayout | None = None) -> torch.Tensor:
    h = forward(params, batch, layout=layout)
    if batch.graph_id is not None:
        h = graph_readout(h, batch.graph_id, batch.num_graphs,
                          batch.node_mask)
    return h @ params["out"]
