"""EquiformerV2-style equivariant graph attention via eSCN SO(2) convolutions
(arXiv:2306.12059 / eSCN arXiv:2302.03655).

Config: 12 layers, C=128 channels, l_max=6, m_max=2, 8 heads.

Per layer:
  1. equivariant norm (per-l RMS over the (2l+1)-vector, per-channel scale),
  2. per edge: rotate (src || dst) irreps into the edge frame (Wigner-D from
     ``so3``), run SO(2) convolutions -- per-m linear maps over (l, channel);
     the m=0 block additionally sees the radial basis of the edge length,
  3. attention: per-head logits from invariant (l=0) features + rbf,
     segment-softmax over destinations,
  4. rotate messages back, aggregate, per-l output projection, residual,
  5. equivariant FFN: per-l channel mixes, l=0 SiLU, l>0 gated by invariant
     sigmoid gates, residual.

Port of ``repro.models.gnn.equiformer_v2``, with its simplifications (an
RMS-style norm, attention logits from input invariants, no S2-grid
activation).  Each layer is checkpointed under autograd.  The per-edge
message tensor is (E, (l_max+1)^2, C); ``edge_chunk`` is accepted and
unused, as in the reference.  With a ``layout`` (``common.GraphLayout``)
the batch is a rank's part of a full graph, its node rows the
reference's ``P(data)`` split: each layer gathers the normed irreps whole
for the edges, the attention softmax is over all ranks' lanes, and the
aggregate comes back onto the rank's rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.graph import segment
from repro_torch.models.gnn import so3
from repro_torch.models.gnn.common import (GraphBatch, GraphLayout,
                                           graph_readout)
from repro_torch.models.gnn.schnet import rbf_expand
from repro_torch.nn.layers import init_dense, normal


def _ls_with_m(l_max: int, m: int) -> list[int]:
    return list(range(m, l_max + 1))


def init_params(gen: torch.Generator, d_in: int, channels: int,
                n_layers: int, l_max: int, m_max: int, n_heads: int,
                n_rbf: int, num_classes: int, dtype=torch.float32) -> dict:
    c = channels
    dev = gen.device

    def ones():
        return torch.ones((l_max + 1, c), dtype=dtype, device=dev)

    layers = []
    for _ in range(n_layers):
        # m = 0: (l_max+1) l's, input 2C per l + rbf, output C per l
        so2 = {"w0": init_dense(gen, (l_max + 1) * 2 * c + n_rbf,
                                (l_max + 1) * c, dtype)}
        for m in range(1, m_max + 1):
            n_l = l_max + 1 - m
            for part in ("r", "i"):
                so2[f"w{m}_{part}"] = init_dense(gen, n_l * 2 * c, n_l * c,
                                                 dtype)
        layers.append({
            "norm_scale": ones(),
            "so2": so2,
            "att_w1": init_dense(gen, 2 * c + n_rbf, c, dtype),
            "att_w2": init_dense(gen, c, n_heads, dtype),
            "proj": normal(gen, (l_max + 1, c, c), c ** -0.5, dtype),
            "ffn_norm_scale": ones(),
            "ffn_in": normal(gen, (l_max + 1, c, 2 * c), c ** -0.5, dtype),
            "ffn_gate": init_dense(gen, c, 2 * c, dtype),
            "ffn_out": normal(gen, (l_max + 1, 2 * c, c), (2 * c) ** -0.5,
                              dtype),
        })
    return {
        "embed": init_dense(gen, d_in, c, dtype),
        "layers": layers,
        "out1": init_dense(gen, c, c, dtype),
        "out2": init_dense(gen, c, num_classes, dtype),
    }


def _equiv_norm(x: torch.Tensor, scale: torch.Tensor, l_max: int,
                eps: float = 1e-6) -> torch.Tensor:
    """Per-l RMS norm over the (2l+1) vector dims and channels."""
    outs = []
    for l, sl in enumerate(so3.block_slices(l_max)):
        blk = x[:, sl, :]
        rms = torch.sqrt(torch.mean(torch.sum(blk * blk, dim=1), dim=-1,
                                    keepdim=True) + eps)
        outs.append(blk / rms[:, None, :] * scale[l][None, None, :])
    return torch.cat(outs, dim=1)


def _so2_conv(so2, feats: torch.Tensor, rbf: torch.Tensor, l_max: int,
              m_max: int, channels: int) -> torch.Tensor:
    """SO(2) convolution in the edge-aligned frame.

    feats: (E, dim, 2C) -- concatenated rotated (src, dst) features.
    Returns messages (E, dim, C); orders |m| > m_max are zero (truncation).
    """
    e = feats.shape[0]
    c = channels
    sls = so3.block_slices(l_max)

    # m = 0 components of each l live at offset l within the block.
    x0 = torch.stack([feats[:, sls[l].start + l, :]
                      for l in range(l_max + 1)], dim=1)  # (E, L+1, 2C)
    x0 = torch.cat([x0.reshape(e, -1), rbf.to(feats.dtype)], dim=-1)
    y0 = (x0 @ so2["w0"]).reshape(e, l_max + 1, c)

    y_pm: dict[int, tuple] = {}
    for m in range(1, m_max + 1):
        ls = _ls_with_m(l_max, m)
        xp = torch.stack([feats[:, sls[l].start + l + m, :] for l in ls],
                         dim=1).reshape(e, -1)    # +m components (E, nl*2C)
        xm = torch.stack([feats[:, sls[l].start + l - m, :] for l in ls],
                         dim=1).reshape(e, -1)    # -m components
        wr, wi = so2[f"w{m}_r"], so2[f"w{m}_i"]
        y_pm[m] = ((xp @ wr - xm @ wi).reshape(e, len(ls), c),
                   (xp @ wi + xm @ wr).reshape(e, len(ls), c))

    # each l block by concatenation along the m axis (m = -l..l)
    blocks = []
    for l in range(l_max + 1):
        cols = []
        if l > m_max:
            cols.append(feats.new_zeros((e, l - m_max, c)))
        for m in range(min(l, m_max), 0, -1):        # m = -min(l,mmax)..-1
            cols.append(y_pm[m][1][:, l - m, None, :])
        cols.append(y0[:, l, None, :])               # m = 0
        for m in range(1, min(l, m_max) + 1):        # m = +1..+min(l,mmax)
            cols.append(y_pm[m][0][:, l - m, None, :])
        if l > m_max:
            cols.append(feats.new_zeros((e, l - m_max, c)))
        blocks.append(torch.cat(cols, dim=1))
    return torch.cat(blocks, dim=1)


def forward(params, batch: GraphBatch, *, l_max: int = 6, m_max: int = 2,
            n_heads: int = 8, n_rbf: int = 16, cutoff: float = 10.0,
            edge_chunk: int | None = None,  # noqa: ARG001
            layout: GraphLayout | None = None) -> torch.Tensor:
    """Returns invariant (l=0) node features (N, C)."""
    emask = batch.edge_mask
    n_rows = batch.node_feat.shape[0]
    n = n_rows if layout is None else layout.num_nodes
    group = None if layout is None else layout.group
    c = params["embed"].shape[1]
    dim = so3.irreps_dim(l_max)
    src, dst = batch.edges[:, 0].long(), batch.edges[:, 1].long()

    pos = batch.positions if layout is None else \
        layout.whole(batch.positions)
    vec = pos.index_select(0, src) - pos.index_select(0, dst)
    dist = torch.sqrt(torch.sum(vec * vec, dim=-1) + 1e-12)
    # Degenerate (zero-length) edges have no edge frame -- mask them out.
    emask = emask * (dist > 1e-6).to(emask.dtype)
    rbf = rbf_expand(dist, n_rbf, cutoff) * emask[:, None]
    d_blocks = so3.wigner_d_real_stack(l_max,
                                       *so3.edge_rotation_angles(vec))

    # initial features: invariant l=0 channels from input node features
    x = batch.node_feat.new_zeros((n_rows, dim, c))
    x[:, 0, :] = batch.node_feat @ params["embed"]

    ch = c // n_heads

    def layer_body(lp, x):
        xn = _equiv_norm(x, lp["norm_scale"], l_max)
        if layout is not None:
            xn = layout.whole(xn)
        # attention logits from invariant inputs + rbf (cheap tensors only)
        inv = torch.cat([xn[:, 0, :].index_select(0, dst),
                         xn[:, 0, :].index_select(0, src),
                         rbf.to(x.dtype)], dim=-1)
        att = F.silu(inv @ lp["att_w1"]) @ lp["att_w2"]      # (E, H)
        alpha = segment.scatter_softmax(att.to(torch.float32), dst, n,
                                        emask, group)

        # rotate (src, dst) into the edge frame
        f_src = so3.rotate_features(xn.index_select(0, src), d_blocks,
                                    l_max)
        f_dst = so3.rotate_features(xn.index_select(0, dst), d_blocks,
                                    l_max)
        feats = torch.cat([f_src, f_dst], dim=-1)          # (E, dim, 2C)
        msg = _so2_conv(lp["so2"], feats, rbf, l_max, m_max, c)
        msg = so3.rotate_features(msg, d_blocks, l_max, inverse=True)
        # per-head attention weights, each head's over its ch channels
        w = alpha.repeat_interleave(ch, dim=-1).to(msg.dtype)  # (E, C)
        msg = msg * w[:, None, :] * emask[:, None, None].to(msg.dtype)
        agg = segment.scatter_sum(msg, dst, n, group=group, rows=True)
        # per-l output projection + residual
        upd = [agg[:, sl, :] @ lp["proj"][l]
               for l, sl in enumerate(so3.block_slices(l_max))]
        x = x + torch.cat(upd, dim=1)

        # FFN
        xf = _equiv_norm(x, lp["ffn_norm_scale"], l_max)
        gates = torch.sigmoid(xf[:, 0, :] @ lp["ffn_gate"])    # (N, 2C)
        outs = []
        for l, sl in enumerate(so3.block_slices(l_max)):
            h = xf[:, sl, :] @ lp["ffn_in"][l]
            h = F.silu(h) if l == 0 else h * gates[:, None, :]
            outs.append(h @ lp["ffn_out"][l])
        return x + torch.cat(outs, dim=1)

    # per-layer remat: the (E, dim, C) rotated-message tensors dominate
    # memory; keep one layer's worth live.
    remat = torch.is_grad_enabled()
    for lp in params["layers"]:
        x = checkpoint(layer_body, lp, x, use_reentrant=False) if remat \
            else layer_body(lp, x)
    return x[:, 0, :]   # invariant readout


def logits(params, batch: GraphBatch, layout: GraphLayout | None = None,
           **kw) -> torch.Tensor:
    h = forward(params, batch, layout=layout, **kw)
    h = F.silu(h @ params["out1"])
    if batch.graph_id is not None:
        h = graph_readout(h, batch.graph_id, batch.num_graphs,
                          batch.node_mask)
    return h @ params["out2"]
