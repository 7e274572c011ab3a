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
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn


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


def init_state(params: nn.Module) -> dict:
    names = [k for k, _ in params.named_parameters()]
    ps = [p.detach() for _, p in params.named_parameters()]
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


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: nn.Module,
                  grads: Sequence[torch.Tensor], state: dict
                  ) -> tuple[nn.Module, dict]:
    """One AdamW step; ``grads`` in ``params.named_parameters()`` order."""
    step = state["step"] + 1
    lr = schedule_lr(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip > 0 else torch.tensor(1.0)
    bc1 = 1 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1 - cfg.b2 ** step.to(torch.float32)
    new = {"m": {}, "v": {}, "master": {}, "step": step}
    named = list(params.named_parameters())
    for (name, p), g in zip(named, grads, strict=True):
        m, v, master = (state["m"][name], state["v"][name],
                        state["master"][name])
        g = g.to(torch.float32) * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m_new / bc1
        vh = v_new / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * master
        master_new = master - lr * delta
        p.copy_(master_new.to(p.dtype))
        new["m"][name], new["v"][name] = m_new, v_new
        new["master"][name] = master_new
    return params, new
