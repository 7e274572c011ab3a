"""Per-family step functions of the launcher: the LM train step.

Port of the LM part of ``repro.launch.steps``: :func:`lm_train_step` is
``_lm_train_cell``'s ``train_step`` -- ``lm_loss`` and its gradients by
autograd, then the repo's AdamW (``repro_torch.optim.adamw``) on the LM
tree held as a ``core.models.ParamTree``.  The reference's sharding specs
and activation constrainers have no counterpart on one device.  The GNN,
recsys and dyngnn cells, the prefill / decode cells and the multi-device
specs wait for ROADMAP Queue 1, item 9d (the dyngnn schedules train
through ``repro_torch.run.Engine``).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from repro_torch.core.models import ParamTree
from repro_torch.models import lm
from repro_torch.optim import adamw


def lm_tree(params: nn.Module) -> dict:
    """A ``ParamTree`` of the LM tree -> the nested dict of its parameters
    that ``repro_torch.models.lm`` takes (the same tensors, no copy)."""
    tree = {k: lm_tree(m) for k, m in params.named_children()}
    tree.update(params.named_parameters(recurse=False))
    return tree


def lm_train_state(gen: torch.Generator, cfg: lm.LMConfig
                   ) -> tuple[ParamTree, dict]:
    """Fresh parameters from ``gen`` (``init_lm_params``) as a
    ``ParamTree`` and their AdamW state (``adamw.init_state``: zero
    moments, fp32 master copies)."""
    params = ParamTree(lm.init_lm_params(gen, cfg))
    return params, adamw.init_state(params)


def lm_loss_and_grads(cfg: lm.LMConfig, params: nn.Module,
                      tokens: torch.Tensor, targets: torch.Tensor
                      ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """``lm_loss`` of the ``ParamTree`` ``params`` and its gradients, in
    ``params.named_parameters()`` order."""
    loss = lm.lm_loss(cfg, lm_tree(params), tokens, targets)
    return loss.detach(), torch.autograd.grad(loss, list(params.parameters()))


def lm_train_step(cfg: lm.LMConfig, opt_cfg: adamw.AdamWConfig | None = None
                  ) -> Callable:
    """-> ``step(params, opt_state, tokens, targets) -> (params, opt_state,
    loss)``: one AdamW step on ``lm_loss`` (tokens and targets (B, S)).
    ``params`` is updated in place and returned; ``opt_cfg`` defaults to
    the reference's ``AdamWConfig(schedule=cfg.lr_schedule)``."""
    opt_cfg = opt_cfg or adamw.AdamWConfig(schedule=cfg.lr_schedule)

    def train_step(params: ParamTree, opt_state: dict, tokens: torch.Tensor,
                   targets: torch.Tensor):
        loss, grads = lm_loss_and_grads(cfg, params, tokens, targets)
        params, opt_state = adamw.apply_updates(opt_cfg, params, grads,
                                                opt_state)
        return params, opt_state, loss

    return train_step
