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

``--sampled`` trains out of core: the trace stays in a host store and
each round streams a fanout-sampled subgraph (``--sample-batch`` seeds,
default N / 4; ``--fanout K1,K2,...``, default 10,10), on ``--mesh P``
ranks under ``torchrun`` (one process joins a one-rank group itself);
rank 0 prints ``sampled ... rounds on P shards, final loss ..., staged
... B, sampled edges ... (dropped ... edges / ... nodes)``.
``--device-budget BYTES`` gates any schedule against a simulated
per-device graph budget; a schedule that does not fit exits with
``refused: ...``::

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
        --arch paper_dyngnn --sampled --mesh 2 --device cpu

``--ckpt-dir DIR`` checkpoints the eager schedule and the distributed
stream (``--stream --mesh P``) there, and a relaunch with it resumes from
the newest checkpoint; a SIGTERM saves one and exits 0.  ``--rescale-at
BLOCK:P`` (repeatable) changes the distributed stream's width to P at
global round BLOCK and ``--rescale-on-preempt P`` absorbs a SIGTERM by
shrinking to P; launch as many processes as the widest width, and rank 0
prints ``streamed ... block rounds elastically (...), final loss ...,
rescales: ...``::

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch paper_dyngnn --stream --mesh 2 --rescale-at 1:4 \
        --ckpt-dir ckpt --device cpu

``--trace`` is known by name and exits naming the ROADMAP item that
ports it.
"""

from __future__ import annotations

import argparse
import os

#: the reference's flags the port does not run yet -> (argparse kwargs,
#: the ROADMAP item that ports them)
_NOT_PORTED = {
    "--trace": ({"default": None}, "Queue 1, item 8c"),
}


def _parse_rescale(spec: str) -> tuple[int, int]:
    """'BLOCK:P' -> (block, new_p) for the plan's rescale schedule."""
    try:
        block, p = spec.split(":")
        return int(block), int(p)
    except ValueError:
        raise SystemExit(
            f"--rescale-at expects BLOCK:P (e.g. 2:8), got {spec!r}"
        ) from None


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
                    help="--stream or --sampled: snapshot-parallel ranks "
                         "of the distributed stream or the sampled "
                         "schedule (> 1: the world size under torchrun)")
    ap.add_argument("--pipeline-rounds", action="store_true",
                    help="--stream --mesh P: queue round r+1's apply and "
                         "step before reading round r's loss (losses "
                         "unchanged)")
    ap.add_argument("--compression", default="none",
                    help="--stream --mesh P: none | int8_a2a (int8 "
                         "error-feedback all-to-alls) | int8_all (also "
                         "the int8 delta wire)")
    ap.add_argument("--sampled", action="store_true",
                    help="out-of-core sampled training: host-resident "
                         "temporal store, fanout-sampled rounds; combine "
                         "with --mesh")
    ap.add_argument("--sample-batch", type=int, default=0, metavar="B",
                    help="--sampled: seed vertices per round (default "
                         "num_nodes // 4)")
    ap.add_argument("--fanout", default="10,10", metavar="K1,K2,...",
                    help="--sampled: per-hop in-neighbor fanouts")
    ap.add_argument("--device-budget", type=int, default=0,
                    metavar="BYTES",
                    help="simulated per-device cap on round-resident graph "
                         "tensors; over-budget schedules refuse with "
                         "DeviceBudgetError")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint the eager schedule or the distributed "
                         "stream here; a relaunch resumes from it")
    ap.add_argument("--rescale-at", action="append", default=[],
                    metavar="BLOCK:P",
                    help="with --stream --mesh: elastically rescale the "
                         "snapshot-parallel width to P at global round "
                         "BLOCK (repeatable; realized at the "
                         "checkpoint-block boundary; losses unchanged)")
    ap.add_argument("--rescale-on-preempt", type=int, default=0,
                    metavar="P",
                    help="with --stream --mesh: absorb SIGTERM by "
                         "shrinking to width P at the next block "
                         "boundary instead of stopping")
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
    if args.sampled and args.stream:
        raise SystemExit("--sampled is its own schedule; drop --stream")
    if (args.sample_batch or args.fanout != "10,10") and not args.sampled:
        raise SystemExit("--sample-batch/--fanout configure the sampled "
                         "schedule; they require --sampled")
    if (args.rescale_at or args.rescale_on_preempt) and not args.stream:
        # fail loudly, never drop the flags: the eager branch has no
        # rescale plumbing, so a typo'd command would otherwise run a
        # plain fixed-width schedule without a word
        raise SystemExit("--rescale-at/--rescale-on-preempt recompose the "
                         "distributed stream; they require "
                         "--stream --mesh P")
    rescale = tuple(_parse_rescale(s) for s in args.rescale_at)
    if args.mesh and not (args.stream or args.sampled):
        raise SystemExit("--mesh P sets the distributed stream's or the "
                         "sampled schedule's width; it requires --stream or "
                         "--sampled (the eager schedule's is "
                         "--data-parallel P)")
    # an elastic run's pool is as wide as its widest width (rescale flags
    # imply --stream)
    elastic = bool(rescale or args.rescale_on_preempt)
    widest = max((args.mesh, args.rescale_on_preempt)
                 + tuple(p for _, p in rescale))
    if elastic and world > 1 and widest != world:
        raise SystemExit(f"--stream under torchrun with {world} processes: "
                         f"the widest width of the elastic policy is "
                         f"{widest}; launch that many processes")
    for mode in ("stream", "sampled"):
        if (getattr(args, mode) and world > 1 and args.mesh != world
                and not elastic):
            raise SystemExit(f"--{mode} under torchrun with {world} "
                             f"processes runs on {world} ranks: pass "
                             f"--mesh {world}")
    try:
        _train(args, dp, world, rescale)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def _join_group(device: str, world: int) -> None:
    """Join the process group torchrun describes in the environment, or a
    one-rank group of this process when there is none (``world`` 1): gloo
    on the CPU, NCCL with this rank on ``cuda:LOCAL_RANK``."""
    import torch
    import torch.distributed as dist

    alone = ({"store": dist.HashStore(), "rank": 0, "world_size": 1}
             if world == 1 else {})
    if device == "cpu":
        dist.init_process_group("gloo", **alone)
        return
    local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", device_id=local, **alone)


def _train(args, dp: int, world: int, rescale: tuple) -> None:
    from repro_torch import resolve_device
    from repro_torch.configs import registry
    from repro_torch.run import CheckpointSpec, DeviceBudgetError, Engine, \
        ExecutionPlan, RunConfig, SamplingSpec, SyntheticTrace

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
    budget = args.device_budget or None
    if args.sampled:
        try:
            fanouts = tuple(int(k) for k in args.fanout.split(","))
        except ValueError:
            raise SystemExit(f"bad --fanout {args.fanout!r}; expected "
                             "K1,K2,...") from None
        spec = SamplingSpec(
            batch_nodes=args.sample_batch or max(cfg.num_nodes // 4, 1),
            fanouts=fanouts)
        plan = ExecutionPlan(mode="sampled", shards=max(args.mesh, 1),
                             num_epochs=args.epochs,
                             overlap=not args.no_overlap,
                             a2a_chunks=args.a2a_chunks,
                             pipeline_rounds=args.pipeline_rounds,
                             compression=args.compression, sampling=spec,
                             device_budget_bytes=budget)
        ckpt = None
        if args.ckpt_dir:
            print("note: --ckpt-dir is ignored with --sampled "
                  "(checkpointing is wired for the eager and streamed "
                  "--mesh schedules)")
    elif args.stream:
        # the pipelining and compression flags pass through as given, so a
        # combination the plan cannot honor (e.g. --pipeline-rounds without
        # --mesh) fails below instead of running a no-op
        plan = ExecutionPlan(
            mode="streamed_mesh" if args.mesh > 1 else "streamed",
            shards=max(args.mesh, 1), num_epochs=args.epochs,
            overlap=not args.no_overlap, a2a_chunks=args.a2a_chunks,
            pipeline_rounds=args.pipeline_rounds,
            compression=args.compression, rescale=rescale,
            rescale_on_preempt=args.rescale_on_preempt,
            device_budget_bytes=budget)
        ckpt = None
        if args.ckpt_dir:
            if plan.mode == "streamed_mesh":
                # round-granular checkpoints of whole host arrays: SIGTERM
                # saves the data cursor; a rerun resumes it, on any legal
                # --mesh width
                ckpt = CheckpointSpec(args.ckpt_dir)
            else:
                print("note: --ckpt-dir is ignored with single-device "
                      "--stream (checkpointing is wired for the eager and "
                      "streamed --mesh schedules)")
    else:
        plan = ExecutionPlan(mode="eager", shards=dp, num_steps=args.steps,
                             a2a_chunks=args.a2a_chunks,
                             pipeline_rounds=args.pipeline_rounds,
                             compression=args.compression,
                             device_budget_bytes=budget)
        ckpt = CheckpointSpec(args.ckpt_dir) if args.ckpt_dir else None
    if world > 1 or args.sampled:
        resolve_device(args.device)       # no card: raise before joining
        _join_group(args.device, world)
    lead = int(os.environ.get("RANK", "0")) == 0
    try:
        engine = Engine(RunConfig(model=cfg, data=data, plan=plan,
                                  checkpoint=ckpt,
                                  log_fn=print if lead else _quiet),
                        device=args.device)
        engine.resolve()
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None
    except ValueError as e:
        raise SystemExit(f"invalid run configuration: {e}") from None
    try:
        result = engine.fit()
    except DeviceBudgetError as e:
        # the budget gate refusing is the answer the flag asks for
        raise SystemExit(f"refused: {e}") from None
    final = f"{result.losses[-1]:.4f}" if result.losses else "n/a"
    if not lead:
        return
    if plan.mode == "sampled":
        srep = result.sample_report
        budget_txt = (f", budget {result.budget_report['required']}"
                      f"/{result.budget_report['budget']} B"
                      if result.budget_report else "")
        print(f"sampled {srep.rounds} rounds on {plan.num_shards} shards, "
              f"final loss {final}, staged {srep.staged_bytes} B, sampled "
              f"edges {srep.sampled_edges} (dropped {srep.dropped_edges} "
              f"edges / {srep.dropped_nodes} nodes){budget_txt}")
        return
    rep = result.transfer_report
    rsc = result.rescale_report
    if plan.mode == "streamed_mesh" and rsc is not None and (
            rsc.events or rsc.preempted or rsc.resumed_from is not None):
        # elastic summary: the width trajectory, not a single per-device
        # figure (each segment has its own P)
        evs = ", ".join(f"{e.old_p}->{e.new_p}@block{e.block}"
                        f" ({e.cause}, {e.payload_bytes} B)"
                        for e in rsc.events) or "none realized"
        if not rsc.preempted:
            state_txt = "completed"
        elif ckpt is not None:
            state_txt = "preempted+checkpointed"
        else:       # no --ckpt-dir: progress was NOT saved
            state_txt = "preempted (no checkpoint configured)"
        print(f"streamed {result.state.step} block rounds elastically "
              f"({state_txt}), final loss {final}, rescales: {evs}")
        return
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
