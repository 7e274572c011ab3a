"""CD-GCN (Manessi et al., "Dynamic graph convolutional networks",
Pattern Recognition 2020; the SC'21 paper's §5.1), plain PyTorch.

Each layer: ``S_t = relu([A_t X_t, A_t X_t W + b])`` (the concat skip) on
every snapshot, then an LSTM along time on every vertex, ``gates = S_t
W_x + h_{t-1} W_h + b`` split i | f | g | o, ``c_t = sigma(f) c_{t-1} +
sigma(i) tanh(g)``, ``h_t = sigma(o) tanh(c_t)``, carried across blocks by
(h, c).  The classifier ``h_t U + c`` gives each (t, u) its logits.
"""

from __future__ import annotations

import torch

from perfbench.reference.common import aggregate, nll_sum


def dims(cfg: dict) -> list[tuple[int, int, int]]:
    """[(d_in, d_gcn, d_out)] a layer."""
    out, d = [], cfg["feat_in"]
    for l in range(cfg["num_layers"]):
        d_out = cfg["out_dim"] if l == cfg["num_layers"] - 1 else \
            cfg["hidden"]
        out.append((d, cfg["hidden"], d_out))
        d = d_out
    return out


def param_shapes(cfg: dict) -> list[tuple[str, tuple, float]]:
    shapes = []
    for l, (d_in, d_gcn, d_out) in enumerate(dims(cfg)):
        shapes += [(f"layers.{l}.gcn.w", (d_in, d_gcn), d_in ** -0.5),
                   (f"layers.{l}.gcn.b", (d_gcn,), 0.0),
                   (f"layers.{l}.lstm.wx", (d_in + d_gcn, 4 * d_out),
                    d_out ** -0.5),
                   (f"layers.{l}.lstm.wh", (d_out, 4 * d_out),
                    d_out ** -0.5),
                   (f"layers.{l}.lstm.b", (4 * d_out,), 0.0)]
    return shapes + [("classifier.u", (cfg["out_dim"], cfg["num_classes"]),
                      cfg["out_dim"] ** -0.5),
                     ("classifier.b", (cfg["num_classes"],), 0.0)]


def init_carries(cfg: dict, n: int, device) -> list[torch.Tensor]:
    return [torch.zeros((n, d_out), device=device)
            for _, _, d_out in dims(cfg) for _ in range(2)]


def block(p, cfg, graphs, frames, labels, carries, t0, mm, rows):
    """One block of snapshots -> (the NLL summed over its (t, u) with u <
    ``rows``, the new carries [h, c] a layer)."""
    h_in = frames
    new = []
    for l in range(cfg["num_layers"]):
        pre = f"layers.{l}."
        w, b = p[pre + "gcn.w"], p[pre + "gcn.b"]
        s = []
        for j, g in enumerate(graphs):
            y0 = aggregate(h_in[j], g)
            s.append(torch.relu(torch.cat([y0, mm(y0, w) + b], dim=-1)))
        h, c = carries[2 * l], carries[2 * l + 1]
        outs = []
        for s_t in s:
            gates = mm(s_t, p[pre + "lstm.wx"]) + mm(h, p[pre + "lstm.wh"]) \
                + p[pre + "lstm.b"]
            i, f, g, o = torch.chunk(gates, 4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        new += [h, c]
        h_in = torch.stack(outs)
    logits = mm(h_in[:, :rows], p["classifier.u"]) + p["classifier.b"]
    return nll_sum(logits, labels[:, :rows]), new
