"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Port of the dyngnn single-device branches of ``repro.launch.train``: it
trains a dynamic-GNN arch (``paper_dyngnn``, ``tmgcn``, ``cdgcn``,
``evolvegcn``) through ``repro_torch.run.Engine`` on a synthetic trace.
By default the blocked trainer runs ``--steps`` steps, evaluates link
prediction and prints the reference's ``done: ...`` line; ``--stream``
runs ``--epochs`` passes of per-snapshot training over the graph-diff
delta stream (the prefetch thread on a side CUDA stream, or inline with
``--no-overlap``) and prints ``streamed ... snapshot steps, final loss
..., transfer ratio ... vs naive``.  ``--device`` defaults to ``cuda``;
``--device cpu`` runs the kernels' plain versions on the host.

Snapshot-partitioned training runs one process per rank under
``torchrun``, which the launcher reads from the environment::

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch paper_dyngnn --data-parallel 4 --device cpu

It joins the process group (gloo for ``--device cpu``, NCCL with rank r
on ``cuda:r`` for ``cuda``), trains with ``--data-parallel P`` ranks (the
world size under ``torchrun``, 1 otherwise) and ``--a2a-chunks`` feature
slices per all-to-all, and only rank 0 evaluates and prints.  The
distributed stream runs the same way with ``--stream --mesh P`` (P, more
than 1, the world size), each rank encoding and streaming its own time
slices, with ``--pipeline-rounds`` and ``--compression
none|int8_a2a|int8_all``; rank 0 prints ``streamed ... block rounds on P
shards, final loss ..., per-device stream ... B (total ... of naive)``::

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
        --arch paper_dyngnn --stream --mesh 2 --pipeline-rounds \
        --compression int8_a2a --device cpu

The reference's other flags are known by name: each exits with one line
naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import argparse
import os

#: the reference's flags the port does not run yet -> (argparse kwargs,
#: the ROADMAP item that ports them)
_NOT_PORTED = {
    "--rescale-at": ({"action": "append", "default": []},
                     "Queue 1, item 8"),
    "--rescale-on-preempt": ({"type": int, "default": 0},
                             "Queue 1, item 8"),
    "--sampled": ({"action": "store_true"}, "Queue 1, item 8"),
    "--sample-batch": ({"type": int, "default": 0}, "Queue 1, item 8"),
    "--fanout": ({"default": "10,10"}, "Queue 1, item 8"),
    "--device-budget": ({"type": int, "default": 0}, "Queue 1, item 8"),
    "--ckpt-dir": ({"default": None}, "Queue 1, item 8"),
    "--trace": ({"default": None}, "Queue 1, item 8"),
}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (paper-width) config instead of "
                         "the smoke config")
    ap.add_argument("--stream", action="store_true",
                    help="per-snapshot training over the graph-diff delta "
                         "stream instead of the blocked trainer")
    ap.add_argument("--no-overlap", action="store_true",
                    help="--stream: encode and stage inline, without the "
                         "prefetch thread")
    ap.add_argument("--epochs", type=int, default=1,
                    help="--stream: passes over the trace")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu "
                         "(the kernels' plain versions)")
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="snapshot-parallel ranks (0 = the world size "
                         "under torchrun, else 1)")
    ap.add_argument("--a2a-chunks", type=int, default=1,
                    help="split each all-to-all of the partitioned step "
                         "into this many feature slices (losses "
                         "unchanged)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="--stream: snapshot-parallel ranks of the "
                         "distributed stream (> 1: the world size under "
                         "torchrun)")
    ap.add_argument("--pipeline-rounds", action="store_true",
                    help="--stream --mesh P: queue round r+1's apply and "
                         "step before reading round r's loss (losses "
                         "unchanged)")
    ap.add_argument("--compression", default="none",
                    help="--stream --mesh P: none | int8_a2a (int8 "
                         "error-feedback all-to-alls) | int8_all (also "
                         "the int8 delta wire)")
    for flag, (kwargs, _) in _NOT_PORTED.items():
        ap.add_argument(flag, **kwargs, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for flag, (kwargs, item) in _NOT_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) != kwargs.get(
                "default", False):
            raise SystemExit(f"{flag} is not ported to PyTorch yet "
                             f"(ROADMAP {item})")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    dp = args.data_parallel or world
    if world > 1 and dp != world:
        raise SystemExit(f"--data-parallel {dp} under torchrun with "
                         f"{world} processes: they must agree")
    if args.mesh and not args.stream:
        raise SystemExit("--mesh P sets the distributed stream's width; it "
                         "requires --stream (the eager schedule's is "
                         "--data-parallel P)")
    if args.stream and world > 1 and args.mesh != world:
        raise SystemExit(f"--stream under torchrun with {world} processes "
                         f"runs the distributed stream: pass --mesh {world}")
    try:
        _train(args, dp, world)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def _join_group(device: str) -> None:
    """Join the process group torchrun describes in the environment:
    gloo on the CPU, NCCL with this rank on ``cuda:LOCAL_RANK``."""
    import torch
    import torch.distributed as dist

    if device == "cpu":
        dist.init_process_group("gloo")
        return
    local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", device_id=local)


def _train(args, dp: int, world: int) -> None:
    from repro_torch.configs import registry
    from repro_torch.run import Engine, ExecutionPlan, RunConfig, \
        SyntheticTrace

    arch = registry.get_arch(args.arch)
    if arch.family != "dyngnn":
        raise SystemExit(f"training the {arch.family} family is not ported "
                         "to PyTorch yet (ROADMAP Queue 1, item 9)")
    cfg = (arch.make_config() if args.full_config
           else arch.make_smoke_config())
    smooth = {"tmgcn": "mproduct", "evolvegcn": "edgelife",
              "cdgcn": "none"}[cfg.model]
    data = SyntheticTrace(num_nodes=cfg.num_nodes, num_steps=cfg.num_steps,
                          density=3.0, churn=0.1, smoothing_mode=smooth,
                          window=cfg.window)
    if args.stream:
        # the pipelining and compression flags pass through as given, so a
        # combination the plan cannot honor (e.g. --pipeline-rounds without
        # --mesh) fails below instead of running a no-op
        plan = ExecutionPlan(
            mode="streamed_mesh" if args.mesh > 1 else "streamed",
            shards=max(args.mesh, 1), num_epochs=args.epochs,
            overlap=not args.no_overlap, a2a_chunks=args.a2a_chunks,
            pipeline_rounds=args.pipeline_rounds,
            compression=args.compression)
    else:
        plan = ExecutionPlan(mode="eager", shards=dp, num_steps=args.steps,
                             a2a_chunks=args.a2a_chunks,
                             pipeline_rounds=args.pipeline_rounds,
                             compression=args.compression)
    if world > 1:
        _join_group(args.device)
    lead = int(os.environ.get("RANK", "0")) == 0
    try:
        engine = Engine(RunConfig(model=cfg, data=data, plan=plan,
                                  log_fn=print if lead else _quiet),
                        device=args.device)
        engine.resolve()
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None
    except ValueError as e:
        raise SystemExit(f"invalid run configuration: {e}") from None
    result = engine.fit()
    final = f"{result.losses[-1]:.4f}" if result.losses else "n/a"
    if not lead:
        return
    rep = result.transfer_report
    if plan.mode == "streamed_mesh":
        # what crossed the links: the per-rank time-sliced streams (their
        # extra slice-boundary fulls), not the single-device stream
        per_dev = result.per_shard_bytes
        comp = (f", compression {result.compression}"
                if result.compression != "none" else "")
        print(f"streamed {result.state.step} block rounds on {args.mesh} "
              f"shards, final loss {final}, per-device stream "
              f"{max(per_dev)} B (total "
              f"{sum(per_dev) / max(rep['naive'], 1):.3f} of naive){comp}")
        return
    if args.stream:
        print(f"streamed {result.state.step} snapshot steps, final loss "
              f"{final}, transfer ratio {rep['ratio']:.3f} vs naive")
        return
    acc = engine.evaluate(result)
    print(f"done: {result.state.step} steps, final loss {final}, "
          f"link-pred acc {acc:.3f}")


def _quiet(_msg: str) -> None:
    return None


if __name__ == "__main__":
    main()
