"""AdamW with fp32 master weights, clipping, and LR schedules (cosine; WSD —
warmup-stable-decay — for MiniCPM).

Port of ``repro.optim.adamw``, written out literally rather than as
``torch.optim.AdamW``: the same master copies, global-norm clipping,
bias corrections and schedules, in float32.  The state mirrors the
parameters: ``m``, ``v`` and ``master`` map each ``ParamTree`` parameter
name (``layers.0.gcn.w`` ...) to a tensor, in the tree's order; ``step``
is a 0-d int32 tensor on the host, so the schedule costs no device sync.
:func:`apply_updates` writes the new values into the parameters in place
(they are the model the next step differentiates) and returns them with
the new state.

Over a grid of ranks (:class:`Zero`, the reference's ``_fsdp_opt_specs``
layout) ``m``, ``v`` and ``master`` hold this rank's shard: each
parameter's tensor-parallel shard, cut once more over the data axis on
one dimension.  A step then all-reduces each gradient over the data
column (a form gloo and NCCL both take; gloo has no reduce-scatter) and
keeps this rank's slice of it, takes the clipping norm of the global
gradient (squares of model-split leaves summed over the model row, every
other leaf counted once), updates its master slice and all-gathers the
new parameter slices over the data column into their tensor-parallel
layout.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Sequence

import torch
from torch import nn

from repro_torch.dist import sharding as shd


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"          # cosine | wsd | constant
    stable_frac: float = 0.8          # WSD: fraction of steps at peak LR
    min_lr_frac: float = 0.1


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (0-d), in float32."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        frac = torch.tensor(1.0)
    elif cfg.schedule == "cosine":
        t = torch.clamp((s - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) \
            * 0.5 * (1 + torch.cos(math.pi * t))
    elif cfg.schedule == "wsd":
        # warmup -> stable plateau -> linear decay (MiniCPM, arXiv:2404.06395)
        stable_end = cfg.warmup_steps + cfg.stable_frac * \
            (cfg.total_steps - cfg.warmup_steps)
        decay_t = torch.clamp((s - stable_end)
                              / max(cfg.total_steps - stable_end, 1),
                              0.0, 1.0)
        frac = 1.0 - (1.0 - cfg.min_lr_frac) * decay_t
    else:
        raise ValueError(cfg.schedule)
    return cfg.lr * warm * frac


@dataclass(frozen=True)
class Zero:
    """How a rank of ``grid`` holds each parameter (by ``ParamTree``
    name): ``model_split`` names the parameters split over the model row
    (their gradients' squares sum over it in the norm), ``data_dim`` the
    dimension its ``m`` / ``v`` / ``master`` are split on over the data
    column (absent: held whole)."""

    grid: Any
    model_split: frozenset = field(default_factory=frozenset)
    data_dim: dict = field(default_factory=dict)

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a tensor-parallel shard ``t`` of ``name``
        (a view)."""
        dim = self.data_dim.get(name)
        if dim is None:
            return t
        n = t.shape[dim] // self.grid.pd
        return t.narrow(dim, self.grid.data_index * n, n)


def init_state(params: nn.Module, zero: Zero | None = None) -> dict:
    """Zero moments and fp32 master copies (with ``zero``: of this rank's
    slices)."""
    names = [k for k, _ in params.named_parameters()]
    ps = [p.detach() for _, p in params.named_parameters()]
    if zero is not None:
        ps = [zero.local(k, p) for k, p in zip(names, ps, strict=True)]
    return {
        "m": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in zip(names, ps, strict=True)},
        "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in zip(names, ps, strict=True)},
        "master": {k: p.to(torch.float32, copy=True)
                   for k, p in zip(names, ps, strict=True)},
        "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32))) for x in tensors]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _sharded_norm(zero: Zero, names: list[str],
                  grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The global gradient's norm from this rank's (data-reduced)
    tensor-parallel shards."""
    split = [torch.sum(torch.square(g.to(torch.float32)))
             for k, g in zip(names, grads, strict=True)
             if k in zero.model_split]
    whole = [torch.sum(torch.square(g.to(torch.float32)))
             for k, g in zip(names, grads, strict=True)
             if k not in zero.model_split]
    zero_t = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    sq = shd.all_reduce(torch.sum(torch.stack(split)) if split else zero_t,
                        zero.grid.model if zero.grid.pm > 1 else None, "tp")
    return torch.sqrt(sq + (torch.sum(torch.stack(whole)) if whole
                            else zero_t))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: nn.Module,
                  grads: Sequence[torch.Tensor], state: dict,
                  zero: Zero | None = None) -> tuple[nn.Module, dict]:
    """One AdamW step; ``grads`` in ``params.named_parameters()`` order
    (with ``zero``: this rank's gradients of its shards, before the data
    column's sum)."""
    step = state["step"] + 1
    lr = schedule_lr(cfg, step)
    named = list(params.named_parameters())
    if zero is not None:
        data = zero.grid.data if zero.grid.pd > 1 else None
        grads = [shd.all_reduce(g.to(torch.float32), data, "dp")
                 for g in grads]
        gnorm = _sharded_norm(zero, [k for k, _ in named], grads)
    else:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip > 0 else torch.tensor(1.0)
    bc1 = 1 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1 - cfg.b2 ** step.to(torch.float32)
    new = {"m": {}, "v": {}, "master": {}, "step": step}
    for (name, p), g in zip(named, grads, strict=True):
        m, v, master = (state["m"][name], state["v"][name],
                        state["master"][name])
        if zero is not None:
            g = zero.local(name, g)
        g = g.to(torch.float32) * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m_new / bc1
        vh = v_new / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * master
        master_new = master - lr * delta
        if zero is not None and name in zero.data_dim:
            p.copy_(shd.all_gather_dim(master_new.to(p.dtype),
                                       zero.grid.data, zero.data_dim[name],
                                       "dp"))
        else:
            p.copy_(master_new.to(p.dtype))
        new["m"][name], new["v"][name] = m_new, v_new
        new["master"][name] = master_new
    return params, new
