"""The training workers behind ``Engine.fit()`` (port of
``repro.run.workers``).

* ``fit_eager`` — the blocked trainer: the step from
  ``train.trainer.make_single_device_train_step`` run ``plan.num_steps``
  times over the pipeline's batch or, on a process group, the
  snapshot-partitioned step (``make_dyngnn_train_step``) over the rank's
  own blocked steps (``DTDGPipeline.rank_arrays``; their CSR pairs built
  once per run), with each step in a fenced ``train.step`` span when
  tracing is on, timed by the straggler watchdog (``ft.straggler``),
  with async checkpoints every ``CheckpointSpec.every`` steps and a
  blocking one on SIGTERM (``ckpt``, ``ft.elastic.PreemptionGuard``;
  rank 0 writes, every rank restores);
* ``fit_streamed`` — per-snapshot online training over the graph-diff
  delta stream (``stream.train_loop.train_streamed``), ``plan.num_epochs``
  passes.  It reads the pipeline's stream statistics, ``max_edges`` and
  block size, never its padded batch: device memory follows the edge ring,
  not T;
* ``fit_streamed_mesh`` — this rank's time-slice delta stream under
  snapshot partitioning (``stream.distributed``), ``plan.num_epochs``
  passes over the stream it encodes once (cached on the bundle with the
  step); an elastic (``rescale`` / ``rescale_on_preempt``) or
  checkpointed plan runs through ``elastic.train_elastic_streamed``,
  the segment loop that changes the width at checkpoint-block
  boundaries and checkpoints / resumes the data cursor;
* ``fit_sampled`` — out-of-core sampled training (``hoststore``): the
  trace stays host-resident in a ``TemporalCSRStore`` (built once from
  the pipeline's own delta items and cached on the bundle with the step)
  and only fanout-sampled subgraph tensors reach the device.

Every worker first gates against ``plan.device_budget_bytes``
(``_budget_gate``) BEFORE allocating device graph tensors: full-graph
schedules refuse a graph whose resident tensors exceed the budget
(``DeviceBudgetError`` names the sampled schedule as the way out).
A SIGTERM reaches one process: on a group the ranks agree on it
(``all_reduce(MAX)``) before any of them stops.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.core import models as dyn_models
from repro_torch.dist import compression as compression_lib
from repro_torch import hoststore
from repro_torch.dist.sharding import ShardLayout, group_rank
from repro_torch.ft.elastic import PreemptionGuard
from repro_torch.ft.straggler import StepTimer
from repro_torch.hoststore import budget as hostbudget
from repro_torch.optim import adamw
from repro_torch.run.config import ResolvedRun, RunResult
from repro_torch.stream import distributed as stream_dist
from repro_torch.stream import encoder as stream_enc
from repro_torch.stream import train_loop as stream_train
from repro_torch.train import trainer


def _init(rr: ResolvedRun, params):
    """``params`` (a ``ParamTree``), or fresh ones drawn from ``rr.seed``,
    on the run's device, with a fresh AdamW state."""
    if params is None:
        params = dyn_models.init_params(
            torch.Generator().manual_seed(rr.seed), rr.cfg)
    params = params.to(rr.device)
    return params, adamw.init_state(params)


def _budget_gate(rr: ResolvedRun, resolved=None) -> dict | None:
    """Gate the schedule against ``plan.device_budget_bytes`` BEFORE any
    device graph tensor is allocated (raises ``DeviceBudgetError`` when
    the resident graph tensors do not fit)."""
    plan = rr.plan
    return hostbudget.check_budget(
        plan.mode, plan.device_budget_bytes,
        num_steps=rr.ds.num_steps, win=rr.pipeline.bsize,
        num_shards=plan.num_shards, max_edges=rr.pipeline.max_edges,
        num_nodes=rr.ds.num_nodes,
        feat_dim=rr.ds.frames.shape[-1], resolved=resolved)


def fit_eager(rr: ResolvedRun, params=None) -> RunResult:
    """``params``: initial parameters (a ``ParamTree`` on the run's
    device, updated in place); drawn from ``rr.seed`` when None.  With a
    checkpoint in ``rr.checkpoint``'s directory the run resumes at its
    step with its parameters and AdamW state."""
    budget = _budget_gate(rr)
    num_steps = rr.plan.num_steps
    opt_cfg = rr.opt_cfg or adamw.AdamWConfig(
        lr=1e-2, warmup_steps=10, total_steps=num_steps, weight_decay=0.0)
    params, opt_state = _init(rr, params)
    start_step = 0
    ckpt = Checkpointer(rr.checkpoint.directory) if rr.checkpoint else None
    if ckpt and ckpt.latest_step() is not None:
        s = ckpt.latest_step()
        (params, opt_state), extra = ckpt.restore(s, (params, opt_state))
        start_step = extra.get("train_step", s)
        rr.log_fn(f"resumed from checkpoint step {start_step}")
    # the parameters are replicated: one rank writes
    writer = ckpt if rr.mesh is None or group_rank(rr.mesh) == 0 else None
    step_fn = rr.cache.get("eager_step")
    pipe = rr.pipeline
    if rr.mesh is not None:
        if step_fn is None:
            step_fn = trainer.make_dyngnn_train_step(
                rr.cfg, rr.mesh, opt_cfg, axis=rr.plan.mesh_axis,
                a2a_chunks=rr.plan.a2a_chunks)
            rr.cache["eager_step"] = step_fn
        layout = ShardLayout.of(rr.mesh, pipe.nb, pipe.bsize,
                                rr.cfg.num_nodes)
        args = pipe.rank_arrays(layout)
        kwargs = {"csrs": pipe.rank_batch(layout).csr_pairs()}
    else:
        if step_fn is None:
            step_fn = trainer.make_single_device_train_step(rr.cfg, opt_cfg)
            rr.cache["eager_step"] = step_fn
        batch = pipe.batch
        args = (batch, torch.from_numpy(rr.ds.labels).to(batch.frames.device))
        kwargs = {}

    def save(step: int, blocking: bool = False) -> None:
        if writer is not None:
            writer.save(step, (params, opt_state),
                        extra={"train_step": step}, blocking=blocking)

    timer = StepTimer()
    losses: list[float] = []
    with PreemptionGuard() as guard:
        for step in range(start_step, num_steps):
            with timer:
                with obs.span("train.step", step=step) as sp:
                    params, opt_state, loss = step_fn(params, opt_state,
                                                      *args, **kwargs)
                    sp.fence(loss)
                losses.append(float(loss))
            if step % rr.log_every == 0:
                rr.log_fn(f"step {step} loss {losses[-1]:.4f}")
            if ckpt and (step + 1) % rr.checkpoint.every == 0:
                save(step + 1)
            stop = guard.preempted
            if rr.mesh is not None:
                stop = stream_dist.agreed(stop, rr.mesh, rr.device)
            if stop:
                rr.log_fn(f"preempted at step {step}; checkpointing and "
                          "exiting cleanly")
                save(step + 1, blocking=True)
                break
    if ckpt:
        ckpt.wait()
        if rr.mesh is not None:
            # no rank reads the directory before rank 0 has written it
            stream_dist.agreed(False, rr.mesh, rr.device)
    state = trainer.TrainState(
        params=params, opt_state=opt_state,
        step=min(num_steps, start_step + len(losses)))
    return RunResult(state=state, losses=losses,
                     transfer_report=pipe.transfer_bytes(),
                     a2a_chunks=rr.plan.a2a_chunks, budget_report=budget)


def fit_streamed(rr: ResolvedRun, params=None) -> RunResult:
    """``params`` as for :func:`fit_eager`."""
    plan, ds, pipe = rr.plan, rr.ds, rr.pipeline
    budget = _budget_gate(rr)
    opt_cfg = rr.opt_cfg or adamw.AdamWConfig(
        lr=1e-2, warmup_steps=10,
        total_steps=plan.num_epochs * ds.num_steps, weight_decay=0.0)
    params, opt_state = _init(rr, params)
    step_fn = rr.cache.get("stream_step")
    if step_fn is None:
        step_fn = stream_train.make_stream_train_step(rr.cfg, opt_cfg)
        rr.cache["stream_step"] = step_fn
    report = stream_enc.StreamReport()
    st = stream_train.train_streamed(
        rr.cfg, ds.snapshots, ds.values, ds.frames, ds.labels,
        block_size=pipe.bsize, num_epochs=plan.num_epochs,
        overlap=plan.overlap, prefetch_depth=plan.prefetch_depth,
        opt_cfg=opt_cfg, params=params, opt_state=opt_state,
        stats=pipe.stream_stats, max_edges=pipe.max_edges, report=report,
        step_fn=step_fn, log_every=rr.log_every, log_fn=rr.log_fn,
        device=rr.device)
    state = trainer.TrainState(params=st.params, opt_state=st.opt_state,
                               step=len(st.losses))
    return RunResult(state=state, losses=st.losses, stream_report=report,
                     transfer_report=pipe.transfer_bytes(),
                     budget_report=budget)


def fit_streamed_mesh(rr: ResolvedRun, params=None) -> RunResult:
    """``params`` as for :func:`fit_eager`.  Every rank of the plan's
    group runs it; each encodes, stages and applies only its own time
    slices."""
    plan, ds, pipe = rr.plan, rr.ds, rr.pipeline
    budget = _budget_gate(rr)
    opt_cfg = rr.opt_cfg or adamw.AdamWConfig(
        lr=1e-2, warmup_steps=10,
        total_steps=plan.num_epochs * ds.num_steps, weight_decay=0.0)
    if plan.is_elastic or rr.checkpoint is not None:
        return _fit_streamed_mesh_elastic(rr, opt_cfg, budget, params)
    params, opt_state = _init(rr, params)
    step_fn = rr.cache.get("dist_step")
    if step_fn is None:
        step_fn = stream_dist.make_dist_stream_step(
            rr.cfg, rr.mesh, opt_cfg, a2a_chunks=plan.a2a_chunks,
            compression=plan.compression)
        rr.cache["dist_step"] = step_fn
    shard_stream = rr.cache.get("shard_stream")
    if shard_stream is None:
        shard_stream = pipe.sharded_streams(
            plan.num_shards, wire=compression_lib.wire_mode(plan.compression),
            rank=group_rank(rr.mesh))[0]
        rr.cache["shard_stream"] = shard_stream
    st = stream_dist.train_distributed_streamed(
        rr.cfg, ds.snapshots, ds.values, ds.frames, ds.labels,
        mesh=rr.mesh, block_size=pipe.bsize,
        num_epochs=plan.num_epochs, overlap=plan.overlap,
        prefetch_depth=plan.prefetch_depth, a2a_chunks=plan.a2a_chunks,
        pipeline_rounds=plan.pipeline_rounds, compression=plan.compression,
        opt_cfg=opt_cfg, params=params, opt_state=opt_state,
        stats=pipe.stream_stats, max_edges=pipe.max_edges, step_fn=step_fn,
        shard_stream=shard_stream, log_every=rr.log_every,
        log_fn=rr.log_fn, device=rr.device)
    state = trainer.TrainState(params=st.params, opt_state=st.opt_state,
                               step=len(st.losses))
    return RunResult(state=state, losses=st.losses,
                     transfer_report=pipe.transfer_bytes(),
                     per_shard_bytes=st.per_shard_bytes,
                     a2a_chunks=plan.a2a_chunks,
                     pipeline_rounds=plan.pipeline_rounds,
                     compression=plan.compression, budget_report=budget)


def _fit_streamed_mesh_elastic(rr: ResolvedRun, opt_cfg: adamw.AdamWConfig,
                               budget: dict | None = None,
                               params=None) -> RunResult:
    """Elastic / checkpointed variant of the streamed_mesh schedule.

    Same round protocol, driven in constant-width segments by
    ``elastic.train_elastic_streamed`` on the plan's pool (the default
    group when the plan is elastic, else its own group): scripted
    rescales and SIGTERM shrinks recompose the stream at block
    boundaries, and a configured ``CheckpointSpec`` enables
    round-granular save + resume (onto any legal width: the checkpoint
    holds whole host arrays).
    """
    from repro_torch import elastic as el

    plan, ds, pipe = rr.plan, rr.ds, rr.pipeline
    params, opt_state = _init(rr, params)
    rt = rr.cache.get("elastic_runtime")
    if rt is None or rt.a2a_chunks != plan.a2a_chunks:
        pool = dist.group.WORLD if plan.is_elastic else rr.mesh
        rt = el.ElasticRuntime(rr.cfg, opt_cfg,
                               (plan.num_shards,) + plan.rescale_widths,
                               pool, a2a_chunks=plan.a2a_chunks)
        rt.groups[plan.num_shards] = rr.mesh
        rr.cache["elastic_runtime"] = rt

    ckpt = Checkpointer(rr.checkpoint.directory) if rr.checkpoint else None
    rpe = ds.num_steps // pipe.bsize
    start, carries = 0, None
    if ckpt is not None and ckpt.latest_step() is not None:
        like = {"params": params, "opt": opt_state,
                "carries": dyn_models.init_carries(rr.cfg, params)}
        tree, extra = ckpt.restore(ckpt.latest_step(), like)
        start = int(extra.get("cursor", 0))
        saved_rpe = int(extra.get("rounds_per_epoch", rpe))
        if saved_rpe != rpe:
            # the cursor counts rounds of the ORIGINAL block size; under
            # a plan that re-blocks the timeline it would land mid-block
            # and silently skip (or repeat) snapshots
            raise ValueError(
                f"checkpoint under {rr.checkpoint.directory} was written "
                f"with {saved_rpe} rounds per epoch but this plan blocks "
                f"the timeline into {rpe}; resume with a shard width that "
                "preserves the checkpoint block size")
        params, opt_state = tree["params"], tree["opt"]
        # carries only matter mid-epoch; at an epoch boundary the loop
        # starts fresh ones (the uninterrupted-run semantics)
        carries = tree["carries"] if start % rpe else None
        rr.log_fn(f"resumed streamed_mesh run at round {start} "
                  f"(checkpoint written at P={extra.get('p', '?')}, "
                  f"resuming on P={plan.num_shards})")

    # scripted boundaries BEFORE the resume cursor are history — realized
    # (and recorded) by the run that wrote the checkpoint; replaying them
    # would double-count the payload.  A boundary AT the cursor is still
    # pending: events realize at the top of the iteration for their
    # block, and checkpoints are written with cursor == segment end,
    # i.e. before that iteration ran.
    schedule = tuple((b, p) for b, p in plan.rescale if int(b) >= start)
    with PreemptionGuard() as guard:
        controller = el.RescaleController(
            initial_p=plan.num_shards, schedule=schedule, guard=guard,
            shrink_to=plan.rescale_on_preempt or None)
        st = el.train_elastic_streamed(
            rr.cfg, ds.snapshots, ds.values, ds.frames, ds.labels,
            controller=controller, block_size=pipe.bsize,
            num_epochs=plan.num_epochs, overlap=plan.overlap,
            prefetch_depth=plan.prefetch_depth,
            a2a_chunks=plan.a2a_chunks,
            pipeline_rounds=plan.pipeline_rounds, opt_cfg=opt_cfg,
            params=params, opt_state=opt_state, stats=pipe.stream_stats,
            max_edges=pipe.max_edges, runtime=rt, ckpt=ckpt,
            ckpt_every=(rr.checkpoint.every if rr.checkpoint else 0),
            start_cursor=start, carries=carries, seed=rr.seed,
            log_every=rr.log_every, log_fn=rr.log_fn, device=rr.device)

    # a COMPLETED run that never changed width has one well-defined
    # per-shard byte accounting: the first epoch's segments sum to
    # exactly the encoded stream (epochs replay the same streams, so —
    # like the fixed-width path — the stream is counted once, not per
    # epoch).  Rescaled, resumed, or preempted runs report per-segment
    # PLANNED payloads on the rescale_report instead.
    per_shard = None
    if (st.completed and not st.report.events
            and st.report.resumed_from is None and st.report.segments):
        first_epoch = [seg for seg in st.report.segments if seg[0] < rpe]
        per_shard = [sum(seg[2][s] for seg in first_epoch)
                     for s in range(len(first_epoch[0][2]))]
    state = trainer.TrainState(params=st.params, opt_state=st.opt_state,
                               step=st.cursor)
    return RunResult(state=state, losses=st.losses,
                     transfer_report=pipe.transfer_bytes(),
                     per_shard_bytes=per_shard,
                     a2a_chunks=plan.a2a_chunks,
                     pipeline_rounds=plan.pipeline_rounds,
                     rescale_report=st.report, budget_report=budget)


def fit_sampled(rr: ResolvedRun, params=None) -> RunResult:
    """Out-of-core sampled schedule: host-resident store + fanout-sampled
    subgraph streaming (``hoststore.train_sampled``), on every rank of
    the plan's group.  ``params`` as for :func:`fit_eager`."""
    plan, ds, pipe = rr.plan, rr.ds, rr.pipeline
    spec = plan.sampling
    resolved = spec.resolve(ds.num_nodes, pipe.bsize, plan.num_shards)
    budget = _budget_gate(rr, resolved)
    opt_cfg = rr.opt_cfg or adamw.AdamWConfig(
        lr=1e-2, warmup_steps=10,
        total_steps=plan.num_epochs * ds.num_steps, weight_decay=0.0)
    params, opt_state = _init(rr, params)
    store = rr.cache.get("host_store")
    if store is None:
        # SAME delta items as the device path: the store ingests the
        # pipeline's IncrementalEncoder stream, no second decode
        store = hoststore.TemporalCSRStore.from_stream(
            pipe.host_stream(), ds.num_nodes)
        rr.cache["host_store"] = store
    step_fn = rr.cache.get("sampled_step")
    if step_fn is None:
        step_fn = hoststore.make_sampled_step(
            rr.cfg, resolved, rr.mesh, opt_cfg, a2a_chunks=plan.a2a_chunks)
        rr.cache["sampled_step"] = step_fn
    st = hoststore.train_sampled(
        rr.cfg, store, ds.frames, ds.labels, spec=spec, mesh=rr.mesh,
        block_size=pipe.bsize, num_epochs=plan.num_epochs,
        overlap=plan.overlap, prefetch_depth=plan.prefetch_depth,
        a2a_chunks=plan.a2a_chunks, opt_cfg=opt_cfg, params=params,
        opt_state=opt_state, step_fn=step_fn, seed=rr.seed,
        log_every=rr.log_every, log_fn=rr.log_fn, device=rr.device)
    state = trainer.TrainState(params=st.params, opt_state=st.opt_state,
                               step=len(st.losses))
    return RunResult(state=state, losses=st.losses,
                     transfer_report=pipe.transfer_bytes(),
                     a2a_chunks=plan.a2a_chunks,
                     sample_report=st.report, budget_report=budget)
