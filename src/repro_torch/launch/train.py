"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Port of ``repro.launch.train`` for the dyngnn, LM, GNN and recsys
families.  A dynamic-GNN arch (``paper_dyngnn``, ``tmgcn``, ``cdgcn``,
``evolvegcn``) trains through ``repro_torch.run.Engine`` on a synthetic
trace.
By default the blocked trainer runs ``--steps`` steps, evaluates link
prediction and prints the reference's ``done: ...`` line; ``--stream``
runs ``--epochs`` passes of per-snapshot training over the graph-diff
delta stream (the prefetch thread on a side CUDA stream, or inline with
``--no-overlap``) and prints ``streamed ... snapshot steps, final loss
..., transfer ratio ... vs naive``.  ``--device`` defaults to ``cuda``;
``--device cpu`` runs the kernels' plain versions on the host.

An LM, static-GNN or recsys arch takes ``--steps`` steps of its family's
train cell (``launch.steps.build_cell``: ``train_4k``, ``molecule`` or
``train_batch``), from the cell's ``make_inputs(0)``: parameters from the
model's own init (``torch.Generator`` seed 0), ``adamw.init_state`` and a
real batch.  With the smoke config the shape takes the reference
launcher's smoke override (``SMOKE_SHAPE``); ``--full-config`` keeps the
registry's shape for a GNN or ``din``.  An LM (``yi-6b``, ``gemma-7b``,
``minicpm-2b``, ``olmoe-1b-7b``, ``moonshot-v1-16b-a3b``) trains on the
reference's smoke batch with either config -- 2 sequences of 128 tokens,
tokens and targets from ``np.random.default_rng(0).integers(0, 2, .)`` --
in place of the cell's (``train_4k``'s 256 x 4,096 tokens would not fit
one card at full width);
a GNN (``gatedgcn``, ``pna``, ``schnet``, ``equiformer-v2``) on the
reference's ``batch_molecules`` (2 graphs of 16 nodes and 32 edges, 8
features, 2 classes; 128 graphs of 30 nodes and 64 edges with
``--full-config``); ``din`` on ``launch.steps.din_batch`` (16 examples;
65,536 with ``--full-config``).  Each prints the reference's ``step i
loss x`` lines (every ``steps // 10``) and ``done``.  The reference's
launcher fills the cell's abstract inputs with N(0, 0.1) draws (AdamW's
second moment included) and its ids with 0 or 1, and its losses go NaN
after step 0; the port's stay finite.  Every family's cell also trains under
``torchrun``, as the reference's launcher does: ``make_host_mesh(data=dp,
model=world // dp)`` (``--data-parallel dp``, default the world size),
each rank stepping its share of the cell (``launch.steps.build_cell`` over
the grid), rank 0 alone printing, over the reference's global smoke batch:
2 x dp sequences for an LM, 2 x dp ``molecule`` graphs for a GNN (dp
replicas of 2 graphs, one a data rank, replica r drawn from
``default_rng(r)``), 16 x dp examples for ``din`` (its rows over data, its
tables over model).  In one process ``--data-parallel dp`` takes the same
global batch on one rank (a GNN's dp replicas, the reference's ``vmap``)::

    python -m repro_torch.launch.train --arch olmoe-1b-7b --steps 10 \
        --device cpu
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch olmoe-1b-7b --data-parallel 2 --steps 10 --device cpu
    python -m repro_torch.launch.train --arch equiformer-v2 --steps 3 \
        --device cpu
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch gatedgcn --data-parallel 2 --steps 3 --device cpu
    python -m repro_torch.launch.train --arch din --steps 10 --device cpu
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch din --data-parallel 2 --steps 3 --device cpu

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

``--trace OUT.json`` (or ``.jsonl``) turns on the ``repro_torch.obs``
tracer and exports the run's spans as a Perfetto-loadable Chrome trace;
the process prints ``trace: N spans -> OUT``, and a ``--stream --mesh P``
run also prints the ``round_time_model`` calibration summary of its
rounds.  Under ``torchrun`` rank 0 writes ``OUT`` and prints, and rank
r > 0 writes ``<stem>.rank<r><suffix>`` beside it (each file's events
carry its own process id, so they open together)::

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
        --arch paper_dyngnn --stream --mesh 2 --trace trace.json \
        --device cpu
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path


def _finish_trace(path: str | None, result, rank: int) -> None:
    """Export the session trace (``--trace``) and, on rank 0 of a mesh
    run, print the model-vs-measured calibration summary."""
    if not path:
        return
    from repro_torch import obs
    trc = obs.get_tracer()
    if rank:
        p = Path(path)
        path = p.with_name(f"{p.stem}.rank{rank}{p.suffix}")
    out = obs.export_trace(path)
    if rank:
        return
    dropped = f" ({trc.dropped} spans dropped)" if trc.dropped else ""
    print(f"trace: {len(trc.spans())} spans -> {out}{dropped}")
    if result is not None and result.per_shard_bytes is not None:
        # int8 wire formats quarter the a2a bytes the model predicts
        ratio = 0.25 if result.compression != "none" else 1.0
        rep = obs.calibration_report(
            trc.spans(), chunks=result.a2a_chunks,
            pipeline_rounds=result.pipeline_rounds, a2a_wire_ratio=ratio)
        print(rep.summary())


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
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="enable the repro_torch.obs tracer and export a "
                         "Perfetto-loadable Chrome trace of the run "
                         "(phase spans + counters; .jsonl for one event "
                         "per line); --stream --mesh runs also print the "
                         "round_time_model calibration residuals")
    args = ap.parse_args(argv)
    if args.trace:
        from repro_torch import obs
        obs.configure(enabled=True)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    dp = args.data_parallel or world
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

        from repro_torch.elastic import drop_width_groups
        drop_width_groups()      # no group may outlive the teardown
        if dist.is_initialized():
            dist.destroy_process_group()


def _train(args, dp: int, world: int, rescale: tuple) -> None:
    from repro_torch import resolve_device
    from repro_torch.configs import registry
    from repro_torch.launch import mesh
    from repro_torch.run import CheckpointSpec, DeviceBudgetError, Engine, \
        ExecutionPlan, RunConfig, SamplingSpec, SyntheticTrace

    arch = registry.get_arch(args.arch)
    if arch.family in SMOKE_SHAPE:
        _train_cell(args, arch, world, dp)
        return
    if world > 1 and dp != world:
        raise SystemExit(f"--data-parallel {dp} under torchrun with "
                         f"{world} processes: they must agree")
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
        mesh.join_world(args.device)
    rank = int(os.environ.get("RANK", "0"))
    lead = rank == 0
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
    _finish_trace(args.trace, result, rank)
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


LM_BATCH, LM_SEQ = 2, 128      # the reference launcher's smoke batch
#: the reference launcher's smoke override of the ``molecule`` shape (its
#: batch 2 graphs a data rank)
GNN_SMOKE_SHAPE = {"n_nodes": 16, "n_edges": 32, "batch": 2, "d_feat": 8,
                   "num_classes": 2}
#: the reference launcher's smoke override of the ``train_batch`` shape (a
#: data rank's examples)
DIN_SMOKE_BATCH = 16
#: each family's train cell and its smoke override at one data rank
SMOKE_SHAPE = {"lm": ("train_4k", {"seq_len": LM_SEQ,
                                   "global_batch": LM_BATCH}),
               "gnn": ("molecule", GNN_SMOKE_SHAPE),
               "recsys": ("train_batch", {"batch": DIN_SMOKE_BATCH})}


def _one_process(args, family: str, world: int, dp: int) -> None:
    """Refuse what the lm, gnn and recsys families do not take: a grid
    the world does not fill, and the dyngnn schedules' flags
    (``--data-parallel`` sets the grid and the global batch)."""
    if world > 1 and world % dp:
        raise SystemExit(f"--data-parallel {dp} does not divide the "
                         f"{world} processes into a data x model grid")
    flags = {"--stream": args.stream, "--sampled": args.sampled,
             "--mesh": args.mesh,
             "--ckpt-dir": args.ckpt_dir,
             "--device-budget": args.device_budget,
             "--pipeline-rounds": args.pipeline_rounds,
             "--a2a-chunks": args.a2a_chunks != 1,
             "--compression": args.compression != "none"}
    given = [f for f, on in flags.items() if on]
    if given:
        raise SystemExit(f"{', '.join(given)} configure the dyngnn "
                         f"schedules; the {family} family trains one step "
                         "at a time")


def _global_batch(family: str, override: dict, dp: int) -> dict:
    """A family's smoke override at ``dp`` data ranks (the reference
    launcher's: the batch grows with dp)."""
    if family == "lm":
        return dict(override, global_batch=LM_BATCH * dp)
    if family == "gnn":
        return dict(override, batch=GNN_SMOKE_SHAPE["batch"] * dp)
    return dict(override, batch=DIN_SMOKE_BATCH * dp)


def _train_cell(args, arch, world: int, dp: int) -> None:
    """``--steps`` steps of the family's train cell (``train_4k``,
    ``molecule`` or ``train_batch``; with the smoke config at the
    reference launcher's smoke override at dp data ranks, as an LM's
    always is) from ``make_inputs(0)``; an LM takes the reference's smoke
    batch of 2 x dp sequences in place of the cell's tokens (module
    docstring), over a ``dp x world / dp`` grid under ``torchrun``; in one
    process a GNN with ``--data-parallel dp`` steps dp replicas at once.
    Each step is a fenced ``train.step`` span; (rank 0) prints ``step i
    loss x`` (every ``steps // 10``) and ``done``."""
    _one_process(args, arch.family, world, dp)
    import numpy as np
    import torch

    from repro_torch import obs, resolve_device
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import mesh, steps

    dev = resolve_device(args.device)
    shape_name, override = SMOKE_SHAPE[arch.family]
    override = _global_batch(arch.family, override, dp)
    if args.full_config and arch.family != "lm":
        override = None
    grid = None
    if world > 1:
        mesh.join_world(args.device)
        grid = mesh.make_host_mesh(dp, world // dp)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
    cell = steps.build_cell(args.arch, shape_name, grid,
                            smoke=not args.full_config,
                            shape_override=override, device=dev)
    inputs = list(cell.make_inputs(0))
    step = cell.step
    if arch.family == "lm":
        dims = cell.shape.dims
        rng = np.random.default_rng(0)
        inputs[2:] = [torch.as_tensor(shd.shard(
            rng.integers(0, 2, (dims["global_batch"], dims["seq_len"])),
            cell.in_specs[2], grid or shd.Grid(1, 1, 0, None, None)),
            dtype=torch.int32, device=dev) for _ in range(2)]
    elif arch.family == "gnn" and grid is None and dp > 1:
        # the dp replicas the ranks would hold, stepped on one rank
        seeds = steps.gnn_dims(cell.shape, dp)["seeds"]
        inputs[2:] = [steps.gnn_batches(cell.shape, dp, 0, dev)]
        step = steps.gnn_train_step(args.arch, cell.config, cell.kind,
                                    seeds=seeds)
    params, opt_state, *batch = inputs
    speak = grid is None or grid.rank == 0
    for i in range(args.steps):
        with obs.span("train.step", cat="train", step=i) as sp:
            params, opt_state, loss = step(params, opt_state, *batch)
            sp.fence(loss)
        if i % max(args.steps // 10, 1) == 0 and speak:
            print(f"step {i} loss {float(loss):.4f}")
    _finish_trace(args.trace, None, 0 if grid is None else grid.rank)
    if speak:
        print("done")


def _quiet(_msg: str) -> None:
    return None


if __name__ == "__main__":
    main()
