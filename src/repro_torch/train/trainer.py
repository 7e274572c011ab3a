"""Training step of the paper's dynamic-GNN workload (port of
``repro.train.trainer``).

* :func:`make_single_device_train_step` — the step the Engine's eager
  worker runs on one device: the blocked-checkpoint node loss
  (``core.checkpoint``), its gradients by ``torch.autograd`` through both
  kernels' backward, and the repo's own AdamW;
* :func:`make_dyngnn_train_step` — the same step under snapshot
  partitioning (paper §4.2) on a ``torch.distributed`` process group;
* :func:`evaluate_link_prediction` (paper §6.4), which ``Engine.evaluate``
  wraps.

The reference's deprecated ``train_dyngnn*`` shims have no counterpart
(``repro_torch.run.Engine`` is the one way in).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import checkpoint as ckpt_exec
from repro_torch.core import models as dyn_models
from repro_torch.core import partition
from repro_torch.data.dyngnn import DTDGPipeline
from repro_torch.dist.sharding import DATA_AXIS
from repro_torch.optim import adamw


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def make_dyngnn_train_step(cfg: dyn_models.DynGNNConfig, mesh,
                           opt_cfg: adamw.AdamWConfig, axis=DATA_AXIS,
                           a2a_chunks: int = 1, comm_dtype=None,
                           fuse_final: bool = False):
    """The eager train step under snapshot partitioning on the process
    group ``mesh`` -> ``step(params, opt_state, frames, edges, ew, labels,
    csrs=None) -> (params, opt_state, loss)``, run by every rank on its
    own blocked steps (nb, bsl, ...) with replicated ``params`` (updated
    in place).

    The reference differentiates ``psum(total) / psum(count)`` with
    respect to replicated parameters, which sums every shard's share.
    Here each rank differentiates its share of the loss
    (``partition.snapshot_partition_loss``), one ``all_reduce(SUM)`` per
    gradient leaf sums the shares' gradients, and AdamW (whose
    global-norm clip sees the reduced gradients) updates the parameters
    alike on every rank: an all-reduce hands every rank the same bits.
    The loss reported is the shares' all-reduce, outside autograd.
    ``a2a_chunks`` chunks each redistribution into that many
    feature-sliced all-to-alls (math-identical); ``comm_dtype`` and
    ``fuse_final`` are ``partition.snapshot_partition_loss``'s (off: the
    paper's execution; the reference's dyngnn cell takes bf16 payloads
    and the fused final layer, ``launch.steps.build_cell``).
    """
    if mesh is None:
        raise ValueError("make_dyngnn_train_step needs a process group "
                         "(torch.distributed); the single-device step is "
                         "make_single_device_train_step")
    if axis != DATA_AXIS:
        raise ValueError(f"a process group has the one axis {DATA_AXIS!r}, "
                         f"got axis={axis!r}")
    loss_fn = partition.snapshot_partition_loss(cfg, mesh,
                                                comm_dtype=comm_dtype,
                                                fuse_final=fuse_final,
                                                a2a_chunks=a2a_chunks)

    def train_step(params, opt_state, frames, edges, ew, labels, csrs=None):
        share = loss_fn(params, frames, edges, ew, labels, csrs)
        grads = torch.autograd.grad(share, list(params.parameters()))
        for g in grads:
            dist.all_reduce(g, group=mesh)
        loss = share.detach().clone()
        dist.all_reduce(loss, group=mesh)
        params, opt_state = adamw.apply_updates(opt_cfg, params, grads,
                                                opt_state)
        return params, opt_state, loss

    return train_step


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
