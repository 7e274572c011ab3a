"""What the plain references share: the snapshot graph, the aggregate,
matrix products in float32 or TF32, the loss and AdamW.

Plain PyTorch in float32 with TF32 off.  Nothing here imports the program
(``repro_torch``) or JAX: the Laplacian weights, the graphs and every
update are worked out again from the cell's seed.  A model module
(``tmgcn.py``, ``cdgcn.py``) gives ``param_shapes(cfg)``,
``init_carries(cfg, n, device)`` and ``block(params, cfg, graphs, frames,
labels, carries, t0, mm)``; :func:`train` drives it.

The lower-precision control (``tf32=True``) rounds both operands of every
matrix product, and the gradient each product hands back, to TF32 (10
mantissa bits, round to nearest even), the precision a float32 product
takes on the tensor cores when TF32 is allowed; the sparse aggregate stays
float32, as the tensor cores never run it.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from perfbench import gen

#: snapshots a checkpointed block of the reference holds (memory only: the
#: arithmetic does not depend on it)
BLOCK = 8


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (ties to even)."""
    i = x.contiguous().view(torch.int32)
    r = (i + 0xFFF + ((i >> 13) & 1)) & -8192
    return r.view(torch.float32)


class _RoundTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


def matmul(tf32: bool):
    """-> ``mm(a, b)``: a float32 product, or its TF32 control."""
    if not tf32:
        return torch.matmul
    return lambda a, b: torch.matmul(_RoundTF32.apply(a), _RoundTF32.apply(b))


def laplacian(src: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """Eq. 1's weights over a snapshot's lanes (self-loops included):
    1 / sqrt((1 + out-degree of src) (1 + in-degree of dst))."""
    ones = torch.ones(src.shape[0], dtype=torch.float32, device=src.device)
    outd = torch.zeros(n, device=src.device).index_add_(0, src, ones)
    ind = torch.zeros(n, device=src.device).index_add_(0, dst, ones)
    return torch.rsqrt(1 + outd)[src] * torch.rsqrt(1 + ind)[dst]


def snapshot_graph(seed: int, t: int, traffic: dict, device):
    """-> (src, dst, w, frame, labels) of snapshot t: the raw lanes and N
    self-loops (int32), their weights, the degree features and labels."""
    n = traffic["nodes"]
    raw = gen.raw_edges(seed, t, traffic, device)
    loops = torch.arange(n, dtype=torch.int32, device=device)
    src = torch.cat([raw[0], loops])
    dst = torch.cat([raw[1], loops])
    frame, labels = gen.features_and_labels(raw, n)
    return src, dst, laplacian(src, dst, n), frame, labels


class Aggregate(torch.autograd.Function):
    """``A x`` with ``A[dst, src] = w``; its gradient ``A^T dy``."""

    @staticmethod
    def forward(ctx, x, src, dst, w):
        ctx.graph = (src, dst, w)
        return torch.zeros_like(x).index_add_(0, dst, x[src] * w[:, None])

    @staticmethod
    def backward(ctx, dy):
        src, dst, w = ctx.graph
        return (torch.zeros_like(dy).index_add_(0, src, dy[dst] * w[:, None]),
                None, None, None)


def aggregate(x, graph):
    return Aggregate.apply(x, *graph)


def nll_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None]).sum()


def lr_at(hp: dict, k: int) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then cosine decay to
    ``min_lr_frac`` of it at ``total_steps``; step k counts from 1."""
    warm = min(k / max(hp["warmup_steps"], 1), 1.0)
    t = min(max((k - hp["warmup_steps"])
                / max(hp["total_steps"] - hp["warmup_steps"], 1), 0.0), 1.0)
    frac = hp["min_lr_frac"] + (1 - hp["min_lr_frac"]) * 0.5 \
        * (1 + math.cos(math.pi * t))
    return hp["lr"] * warm * frac


@torch.no_grad()
def adamw(params: dict, grads: dict, state: dict, k: int, hp: dict) -> dict:
    """One AdamW step (global-norm clipping, bias corrections, decoupled
    decay) on ``params`` in place -> the gradients as the moments took
    them (clipped)."""
    gnorm = math.sqrt(sum(float(g.double().square().sum())
                          for g in grads.values()))
    scale = min(1.0, hp["grad_clip"] / max(gnorm, 1e-9)) \
        if hp["grad_clip"] > 0 else 1.0
    lr = lr_at(hp, k)
    b1, b2 = hp["b1"], hp["b2"]
    taken = {}
    for name, p in params.items():
        g = grads[name] * scale
        m = state["m"][name].mul_(b1).add_(g, alpha=1 - b1)
        v = state["v"][name].mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (m / (1 - b1 ** k)) / ((v / (1 - b2 ** k)).sqrt() + hp["eps"])
        p.sub_(lr * (upd + hp["weight_decay"] * p))
        taken[name] = g
    return taken


def graphs_of(seed: int, traffic: dict, device):
    """Every snapshot's graph, frame and labels (the reference's own)."""
    graphs, frames, labels = [], [], []
    for t in range(traffic["steps"]):
        src, dst, w, f, y = snapshot_graph(seed, t, traffic, device)
        graphs.append((src, dst, w))
        frames.append(f)
        labels.append(y)
    return graphs, torch.stack(frames), torch.stack(labels)


def train(model, cfg: dict, traffic: dict, seed: int,
          params0: dict[str, torch.Tensor], steps: int = 3,
          tf32: bool = False, fault: str | None = None,
          data=None) -> dict:
    """``steps`` AdamW steps of ``model`` from ``params0`` on the cell's
    whole timeline -> {"losses": [...], "grad1": {leaf: the first step's
    clipped gradient}, "delta": {leaf: params after the steps - params0}}.

    ``fault`` plants a fault in the reference put in the program's place:
    ``"half_batch"`` takes the mean over the first half of the vertices
    alone.  ``data``: :func:`graphs_of`'s result, when the caller has it.
    """
    device = next(iter(params0.values())).device
    graphs, frames, labels = data if data is not None \
        else graphs_of(seed, traffic, device)
    n, t_steps = traffic["nodes"], traffic["steps"]
    rows = n // 2 if fault == "half_batch" else n
    names = list(params0)
    params = {k: v.detach().clone().requires_grad_() for k, v in
              params0.items()}
    state = {"m": {k: torch.zeros_like(v) for k, v in params0.items()},
             "v": {k: torch.zeros_like(v) for k, v in params0.items()}}
    mm = matmul(tf32)
    bs = math.gcd(BLOCK, t_steps)
    out = {"losses": [], "grad1": None, "delta": None}

    def run_block(t0, *flat):
        p = dict(zip(names, flat[:len(names)], strict=True))
        carries = list(flat[len(names):])
        sl = slice(t0, t0 + bs)
        total, carries = model.block(p, cfg, graphs[sl], frames[sl],
                                     labels[sl], carries, t0, mm, rows)
        return (total, *carries)

    for k in range(1, steps + 1):
        carries = model.init_carries(cfg, n, device)
        total = torch.zeros((), device=device)
        for t0 in range(0, t_steps, bs):
            res = checkpoint(run_block, t0, *params.values(), *carries,
                             use_reentrant=False)
            total = total + res[0]
            carries = list(res[1:])
        loss = total / (t_steps * rows)
        grads = dict(zip(names, torch.autograd.grad(
            loss, list(params.values())), strict=True))
        out["losses"].append(float(loss.detach()))
        taken = adamw(params, grads, state, k, cfg["optimizer"])
        if k == 1:
            out["grad1"] = {kk: v.detach().clone() for kk, v in taken.items()}
    out["delta"] = {k: (params[k].detach() - params0[k]) for k in names}
    return out
