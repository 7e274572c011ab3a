"""PNA -- Principal Neighbourhood Aggregation (arXiv:2004.05718).

Config: 4 layers, d_hidden=75, aggregators {mean, max, min, std} x scalers
{identity, amplification, attenuation} -> 12 aggregate views concatenated,
then a linear post-transform, residual connection.

Scalers use log-degree: S_amp = log(d+1)/delta, S_att = delta/log(d+1), with
delta the mean log-degree of the training graph (computed from the batch).
Port of ``repro.models.gnn.pna``; each layer is checkpointed under
autograd.  On a node with no in-edge S_att is huge (delta / 1e-3) and
multiplies a zero aggregate, so the view is 0, as in the reference.
With a ``layout`` (``common.GraphLayout``) the batch is a rank's part of
a full graph; the degrees, ``delta`` and the four aggregators are the
whole graph's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.graph import segment
from repro_torch.dist import sharding as shd
from repro_torch.models.gnn.common import (GraphBatch, GraphLayout,
                                           graph_readout)
from repro_torch.nn.layers import init_dense

N_AGG = 4
N_SCALE = 3


def init_params(gen: torch.Generator, d_in: int, d_hidden: int,
                n_layers: int, num_classes: int,
                dtype=torch.float32) -> dict:
    layers = [{
        # pre-transform on (h_i || h_j), post-transform on 12 views
        "pre": init_dense(gen, 2 * d_hidden, d_hidden, dtype),
        "post": init_dense(gen, N_AGG * N_SCALE * d_hidden, d_hidden, dtype),
        "b": torch.zeros((d_hidden,), dtype=dtype, device=gen.device),
    } for _ in range(n_layers)]
    return {
        "embed": init_dense(gen, d_in, d_hidden, dtype),
        "layers": layers,
        "out": init_dense(gen, d_hidden, num_classes, dtype),
    }


def forward(params, batch: GraphBatch,
            layout: GraphLayout | None = None) -> torch.Tensor:
    edges, emask = batch.edges, batch.edge_mask
    n = batch.node_feat.shape[0] if layout is None else layout.num_nodes
    group = None if layout is None else layout.group
    src, dst = edges[:, 0].long(), edges[:, 1].long()
    deg = segment.in_degree(edges, n, emask, group=group, rows=True)
    log_deg = torch.log(deg + 1.0)
    weighted, count = torch.sum(log_deg * batch.node_mask), \
        batch.node_mask.sum()
    if layout is not None:
        weighted = shd.all_reduce(weighted, group, "gnn")
        count = shd.all_reduce(count, group, "gnn")
    delta = torch.clamp(weighted / torch.clamp(count, min=1.0), min=1e-3)
    s_amp = (log_deg / delta)[:, None]
    s_att = (delta / torch.clamp(log_deg, min=1e-3))[:, None]

    h = batch.node_feat @ params["embed"]

    def layer(lp, h):
        whole = h if layout is None else layout.whole(h)
        h_src = whole.index_select(0, src)
        h_dst = whole.index_select(0, dst)
        msg = F.relu(torch.cat([h_dst, h_src], -1) @ lp["pre"])
        aggs = [
            segment.scatter_mean(msg, dst, n, emask, group, rows=True),
            segment.scatter_max(msg, dst, n, emask, group, rows=True),
            segment.scatter_min(msg, dst, n, emask, group, rows=True),
            segment.scatter_std(msg, dst, n, emask, group=group, rows=True),
        ]
        views = []
        for a in aggs:
            views.extend([a, a * s_amp.to(a.dtype), a * s_att.to(a.dtype)])
        return h + F.relu(torch.cat(views, -1) @ lp["post"] + lp["b"])

    remat = torch.is_grad_enabled()
    for lp in params["layers"]:
        h = checkpoint(layer, lp, h, use_reentrant=False) if remat \
            else layer(lp, h)
    return h


def logits(params, batch: GraphBatch,
           layout: GraphLayout | None = None) -> torch.Tensor:
    h = forward(params, batch, layout)
    if batch.graph_id is not None:
        h = graph_readout(h, batch.graph_id, batch.num_graphs,
                          batch.node_mask)
    return h @ params["out"]
