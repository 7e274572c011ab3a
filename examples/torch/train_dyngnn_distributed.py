"""End-to-end distributed training on the port (the paper's full stack).

The twin of ``examples/train_dyngnn_distributed.py``.  One ``RunConfig``
per schedule drives: synthetic DTDG + smoothing, graph-diff transfer
accounting, snapshot partitioning over a process group (all-to-alls
between ranks), blocked gradient checkpointing, AdamW, checkpointing,
preemption guard, straggler watchdog — then link-prediction eval; and
the same ranks again ONLINE, with per-rank time-slice delta streams
feeding per-rank edge-buffer rings.

P is the largest of 1, 2, 4, 8 that is at most the number of ranks: one
process a rank under ``torchrun`` (gloo on the CPU, NCCL with one card a
rank), a one-rank group alone:

  torchrun --standalone --nproc-per-node 2 \
      examples/torch/train_dyngnn_distributed.py [--device cpu]
  PYTHONPATH=src python examples/torch/train_dyngnn_distributed.py

Rank 0 prints.
"""

from __future__ import annotations

import argparse
import copy
import shutil
import tempfile

import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core import models
from repro_torch.dist.sharding import group_rank, group_size
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import adamw
from repro_torch.run import (CheckpointSpec, Engine, ExecutionPlan,
                             RunConfig, SyntheticTrace)

STEPS = 300


def _silent(_msg: str) -> None:
    return None


def _shared_dir(rank: int, group) -> str:
    """One checkpoint directory for every rank of ``group``: rank 0 makes
    it (fresh: a stale one would resume past num_steps and leave nothing
    to train) and sends its path to the others."""
    path = [tempfile.mkdtemp(prefix="repro_dyngnn_ckpt_") if rank == 0
            else None]
    if group_size(group) > 1:
        dist.broadcast_object_list(path, src=0, group=group)
    return path[0]


def run(steps: int = STEPS, device: str = "cuda", params=None,
        echo=print) -> dict | None:
    """Join the process group ``torchrun`` describes, or a one-rank group,
    unless one is open, and :func:`train` over its first P ranks; rank 0
    prints and returns the numbers (None on other ranks).  A group this
    function opened is ended before it returns."""
    dev = resolve_device(device)
    opened = mesh_lib.join_world(dev)
    sub = None
    try:
        world = dist.get_world_size()
        p = max(d for d in (1, 2, 4, 8) if d <= world)
        group = dist.group.WORLD
        if p < world:
            sub = group = dist.new_group(list(range(p)))
        rank = dist.get_rank()
        if rank >= p:
            return None
        out = train(group, steps, dev, params,
                    echo if rank == 0 else _silent)
        return out if rank == 0 else None
    finally:
        if opened:
            dist.destroy_process_group()
        elif sub is not None:
            dist.destroy_process_group(sub)


def train(group, steps: int = STEPS, device: str = "cuda", params=None,
          echo=print) -> dict:
    """Train eager for ``steps`` AdamW steps over the P ranks of ``group``
    (on one device at P = 1), evaluate, then stream 2 epochs over them;
    print the example's lines through ``echo`` and return their numbers.
    ``params``: the initial parameters of both runs (a ``ParamTree``);
    drawn from the seed by the port when None."""
    dev = resolve_device(device)
    p, rank = group_size(group), group_rank(group)
    t, n = 32, 512
    cfg = models.DynGNNConfig(model="tmgcn", num_nodes=n, num_steps=t,
                              feat_in=2, hidden=6, out_dim=6, window=5,
                              checkpoint_blocks=4)
    data = SyntheticTrace(num_nodes=n, num_steps=t, density=3.0, churn=0.1,
                          smoothing_mode="mproduct", window=5, seed=0)

    # OFFLINE: the blocked trainer, snapshot-partitioned over the ranks
    # (at P = 1 on one device)
    ckpt_dir = _shared_dir(rank, group)
    try:
        engine = Engine(RunConfig(
            model=cfg, data=data,
            plan=ExecutionPlan(mode="eager", shards=p,
                               mesh=group if p > 1 else None,
                               num_steps=steps),
            optimizer=adamw.AdamWConfig(lr=5e-3, warmup_steps=20,
                                        total_steps=steps,
                                        weight_decay=0.0),
            checkpoint=CheckpointSpec(ckpt_dir, every=100),
            log_every=25, log_fn=echo), params=copy.deepcopy(params),
            device=dev)
        mesh = engine.resolve().mesh
        echo("mesh: " + (str({"data": group_size(mesh), "model": 1})
                         if mesh is not None else "single device"))
        rep = engine.resolve().pipeline.transfer_bytes()
        echo(f"host->device transfer with graph-diff: "
             f"{1 / rep['ratio']:.2f}x reduction")
        result = engine.fit()
        echo(f"trained {result.state.step} steps; loss "
             f"{result.losses[0]:.4f} -> {result.losses[-1]:.4f}")
        acc = engine.evaluate(result)
        echo(f"link-prediction accuracy: {acc:.3f}")
    finally:
        if p > 1:
            dist.barrier(group=group)    # every rank is done with the dir
        if rank == 0:
            shutil.rmtree(ckpt_dir, ignore_errors=True)

    # Same ranks, ONLINE: per-rank time-slice delta streams feed per-rank
    # edge-buffer rings; each checkpoint block trains one snapshot-parallel
    # round while the next block's deltas prefetch.
    streamed = Engine(RunConfig(
        model=cfg, data=data,
        plan=ExecutionPlan(mode="streamed_mesh", shards=p, mesh=group,
                           num_epochs=2),
        log_every=4, log_fn=echo), params=copy.deepcopy(params), device=dev)
    s_result = streamed.fit()
    echo(f"streamed {s_result.state.step} block rounds on {p} shards; "
         f"loss {s_result.losses[0]:.4f} -> {s_result.losses[-1]:.4f}")
    return {"p": p, "mesh": None if mesh is None else group_size(mesh),
            "ratio": rep["ratio"], "steps": result.state.step,
            "losses": list(result.losses), "accuracy": acc,
            "rounds": s_result.state.step,
            "stream_losses": list(s_result.losses),
            "params": result.state.params,
            "stream_params": s_result.state.params}


def main(argv: list[str] | None = None) -> dict | None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS,
                    help=f"eager AdamW steps (default {STEPS})")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return run(args.steps, args.device)


if __name__ == "__main__":
    main()
