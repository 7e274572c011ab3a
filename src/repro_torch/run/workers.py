"""The training workers behind ``Engine.fit()`` (port of
``repro.run.workers``).

* ``fit_eager`` — the blocked trainer: the step from
  ``train.trainer.make_single_device_train_step`` run ``plan.num_steps``
  times over the pipeline's batch or, on a process group, the
  snapshot-partitioned step (``make_dyngnn_train_step``) over the rank's
  own blocked steps (``DTDGPipeline.rank_arrays``; their CSR pairs built
  once per run), with each step in a fenced ``train.step`` span when
  tracing is on;
* ``fit_streamed`` — per-snapshot online training over the graph-diff
  delta stream (``stream.train_loop.train_streamed``), ``plan.num_epochs``
  passes.  It reads the pipeline's stream statistics, ``max_edges`` and
  block size, never its padded batch: device memory follows the edge ring,
  not T;
* ``fit_streamed_mesh`` — this rank's time-slice delta stream under
  snapshot partitioning (``stream.distributed``), ``plan.num_epochs``
  passes over the stream it encodes once (cached on the bundle with the
  step);
* ``fit_sampled`` — out-of-core sampled training (``hoststore``): the
  trace stays host-resident in a ``TemporalCSRStore`` (built once from
  the pipeline's own delta items and cached on the bundle with the step)
  and only fanout-sampled subgraph tensors reach the device.

Every worker first gates against ``plan.device_budget_bytes``
(``_budget_gate``) BEFORE allocating device graph tensors: full-graph
schedules refuse a graph whose resident tensors exceed the budget
(``DeviceBudgetError`` names the sampled schedule as the way out).

The reference's async checkpointing, preemption guard, straggler timer
and elastic segment loop (``ckpt/``, ``ft/``, ``elastic/``) are not
ported yet (ROADMAP Queue 1, item 8).
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core import models as dyn_models
from repro_torch.dist import compression as compression_lib
from repro_torch import hoststore
from repro_torch.dist.sharding import ShardLayout, group_rank
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
    device, updated in place); drawn from ``rr.seed`` when None."""
    budget = _budget_gate(rr)
    num_steps = rr.plan.num_steps
    opt_cfg = rr.opt_cfg or adamw.AdamWConfig(
        lr=1e-2, warmup_steps=10, total_steps=num_steps, weight_decay=0.0)
    params, opt_state = _init(rr, params)
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

    losses: list[float] = []
    for step in range(num_steps):
        with obs.span("train.step", step=step) as sp:
            params, opt_state, loss = step_fn(params, opt_state, *args,
                                              **kwargs)
            sp.fence(loss)
        losses.append(float(loss))
        if step % rr.log_every == 0:
            rr.log_fn(f"step {step} loss {float(loss):.4f}")
    state = trainer.TrainState(params=params, opt_state=opt_state,
                               step=len(losses))
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
