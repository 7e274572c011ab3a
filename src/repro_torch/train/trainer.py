"""Training step of the paper's dynamic-GNN workload (port of
``repro.train.trainer``).

* :func:`make_single_device_train_step` — the step the Engine's eager
  worker runs: the blocked-checkpoint node loss (``core.checkpoint``), its
  gradients by ``torch.autograd`` through both kernels' backward, and the
  repo's own AdamW;
* :func:`evaluate_link_prediction` (paper §6.4), which ``Engine.evaluate``
  wraps.

The snapshot-partitioned step (``make_dyngnn_train_step``) waits for
ROADMAP Queue 1, item 5; the reference's deprecated ``train_dyngnn*``
shims have no counterpart (``repro_torch.run.Engine`` is the one way in).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core import checkpoint as ckpt_exec
from repro_torch.core import models as dyn_models
from repro_torch.data.dyngnn import DTDGPipeline
from repro_torch.optim import adamw


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def make_dyngnn_train_step(cfg: dyn_models.DynGNNConfig, mesh,
                           opt_cfg: adamw.AdamWConfig, axis="data",
                           a2a_chunks: int = 1):
    """The snapshot-partitioned train step: not ported yet."""
    raise NotImplementedError(
        f"make_dyngnn_train_step ({cfg.model} on mesh {mesh!r}, axis "
        f"{axis!r}, a2a_chunks={a2a_chunks}, lr={opt_cfg.lr}): snapshot "
        "partitioning is not ported yet (ROADMAP Queue 1, item 5)")


def make_single_device_train_step(cfg: dyn_models.DynGNNConfig,
                                  opt_cfg: adamw.AdamWConfig):
    """-> ``step(params, opt_state, batch, labels) -> (params, opt_state,
    loss)``; ``params`` are updated in place and returned."""

    def train_step(params, opt_state, batch, labels):
        loss = ckpt_exec.blocked_node_loss(cfg, params, batch, labels)
        grads = torch.autograd.grad(loss, list(params.parameters()))
        params, opt_state = adamw.apply_updates(opt_cfg, params, grads,
                                                opt_state)
        return params, opt_state, loss.detach()

    return train_step


@torch.no_grad()
def evaluate_link_prediction(cfg, params, pipeline: DTDGPipeline,
                             test_snapshot: np.ndarray, theta: float = 0.1,
                             seed: int = 0) -> float:
    """Paper §6.4 link-prediction protocol: embeddings at step T classify
    edges of snapshot T+1 against random negative pairs."""
    rng = np.random.default_rng(seed)
    z = ckpt_exec.blocked_forward(cfg, params, pipeline.batch,
                                  nb=cfg.checkpoint_blocks)
    z_last = z[-1]
    m = max(1, int(theta * test_snapshot.shape[0]))
    pos = test_snapshot[rng.choice(test_snapshot.shape[0], m,
                                   replace=False)]
    neg = rng.integers(0, pipeline.ds.num_nodes, size=(m, 2))
    pairs = torch.from_numpy(
        np.concatenate([pos, neg], axis=0).astype(np.int32)).to(z.device)
    labels = np.concatenate([np.ones(m), np.zeros(m)])
    logits = dyn_models.link_logits(params, z_last, pairs)
    pred = torch.argmax(logits, dim=-1).cpu().numpy()
    return float((pred == labels).mean())
