"""TM-GCN (Malik et al., "Dynamic Graph Convolutional Networks Using the
Tensor M-Product", SDM 2021; the SC'21 paper's §5.3), plain PyTorch.

Each layer: ``Y_t = relu(A_t X_t W + b)`` on every snapshot, then the
M-product over time, ``Z_t = (1 / min(w, t)) sum_{k = max(1, t - w + 1)}^t
Y_k`` (t 1-indexed), carried across blocks by the last w - 1 frames of Y.
The classifier ``Z U + c`` gives each (t, u) its logits.
"""

from __future__ import annotations

import torch

from perfbench.reference.common import aggregate, nll_sum


def dims(cfg: dict) -> list[tuple[int, int]]:
    """[(d_in, d_out)] a layer."""
    out, d = [], cfg["feat_in"]
    for l in range(cfg["num_layers"]):
        d_out = cfg["out_dim"] if l == cfg["num_layers"] - 1 else \
            cfg["hidden"]
        out.append((d, d_out))
        d = d_out
    return out


def param_shapes(cfg: dict) -> list[tuple[str, tuple, float]]:
    shapes = []
    for l, (d_in, d_out) in enumerate(dims(cfg)):
        shapes += [(f"layers.{l}.gcn.w", (d_in, d_out), d_in ** -0.5),
                   (f"layers.{l}.gcn.b", (d_out,), 0.0)]
    return shapes + [("classifier.u", (cfg["out_dim"], cfg["num_classes"]),
                      cfg["out_dim"] ** -0.5),
                     ("classifier.b", (cfg["num_classes"],), 0.0)]


def init_carries(cfg: dict, n: int, device) -> list[torch.Tensor]:
    return [torch.zeros((cfg["window"] - 1, n, d_out), device=device)
            for _, d_out in dims(cfg)]


def m_product(prefix: torch.Tensor, y: torch.Tensor, window: int,
              t0: int) -> torch.Tensor:
    """Rows t0 .. t0 + len(y) - 1 (0-indexed) of M [.. ; prefix; y]; the
    prefix holds the w - 1 frames before y (zeros before step 0)."""
    full = torch.cat([prefix, y])
    bs = y.shape[0]
    acc = sum(full[window - 1 - s:window - 1 - s + bs]
              for s in range(window))
    denom = torch.clamp(torch.arange(t0 + 1, t0 + bs + 1,
                                     device=y.device), max=window)
    return acc / denom.to(y.dtype)[:, None, None]


def block(p, cfg, graphs, frames, labels, carries, t0, mm, rows):
    """One block of snapshots -> (the NLL summed over its (t, u) with u <
    ``rows``, the new carries)."""
    h = frames
    new = []
    for l, prefix in enumerate(carries):
        w, b = p[f"layers.{l}.gcn.w"], p[f"layers.{l}.gcn.b"]
        y = torch.stack([torch.relu(mm(aggregate(h[j], g), w) + b)
                         for j, g in enumerate(graphs)])
        h = m_product(prefix, y, cfg["window"], t0)
        new.append(torch.cat([prefix, y])[-(cfg["window"] - 1):])
    logits = mm(h[:, :rows], p["classifier.u"]) + p["classifier.b"]
    return nll_sum(logits, labels[:, :rows]), new
