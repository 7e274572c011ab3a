"""The Engine: one way to train (port of ``repro.run.engine``).

    run = RunConfig(model=cfg,
                    data=SyntheticTrace(num_nodes=128, num_steps=16),
                    plan=ExecutionPlan(mode="eager", num_steps=20))
    result = Engine(run, device="cuda").fit()      # -> RunResult

``resolve()`` builds the dataset (its vertex axis padded to a multiple of
the plan's ranks) and the pipeline (whose batch lives on the Engine's
device, built only when a worker reads it) once, and takes the plan's
process group, re-blocking the timeline when the distributed stream needs
it (``ExecutionPlan.resolved_blocks``); ``fit()`` runs the plan's worker
— the blocked trainer for ``mode="eager"`` (snapshot-partitioned on a
group: every rank of the group runs the same Engine, and each moves only
its own steps to its device), the per-snapshot delta-stream trainer for
``mode="streamed"``, the per-rank delta streams under snapshot
partitioning for ``mode="streamed_mesh"``, out-of-core fanout-sampled
rounds over the host-resident store for ``mode="sampled"`` (every rank of
the group runs it; the vertex axis is not padded) — and ``evaluate()``
runs the paper's link-prediction protocol on the trained params.
``device`` defaults to ``"cuda"`` and raises without a card unless the
caller passes ``device="cpu"``; ``params`` may hand in initial parameters
(a ``ParamTree``, e.g. from ``repro_torch.convert.params_from_jax``),
which are otherwise drawn from ``RunConfig.seed``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import obs, resolve_device
from repro_torch.data.dyngnn import DTDGPipeline
from repro_torch.run import workers
from repro_torch.run.config import ResolvedRun, RunConfig, RunResult
from repro_torch.train.trainer import TrainState, evaluate_link_prediction


#: plan.mode -> the worker that runs it
_WORKERS = {"eager": workers.fit_eager, "streamed": workers.fit_streamed,
            "streamed_mesh": workers.fit_streamed_mesh,
            "sampled": workers.fit_sampled}


class Engine:
    """Declarative training engine for the dynamic-GNN workload."""

    def __init__(self, config: RunConfig, params=None,
                 device: str | torch.device = "cuda"):
        config.plan.validate()
        if config.checkpoint is not None:
            raise NotImplementedError(
                "RunConfig.checkpoint: checkpointing (ckpt/) is not ported "
                "yet (ROADMAP Queue 1, item 8)")
        self.config = config
        self.device = resolve_device(device)
        config.plan.check_devices(self.device)
        self._params = params
        self._resolved: ResolvedRun | None = None
        self._last: RunResult | None = None

    def resolve(self) -> ResolvedRun:
        """Build (once) the bundle the worker consumes."""
        if self._resolved is not None:
            return self._resolved
        c = self.config
        mesh = c.plan.build_mesh()
        nominal = c.data.num_nodes
        n = c.plan.padded_num_nodes(nominal, log_fn=c.log_fn)
        ds = c.data.build(num_nodes=n if n != nominal else None)
        nb = c.plan.resolved_blocks(ds.num_steps, c.model.checkpoint_blocks,
                                    log_fn=c.log_fn)
        cfg = c.model
        if (cfg.num_nodes != ds.num_nodes or cfg.num_steps != ds.num_steps
                or cfg.checkpoint_blocks != nb):
            cfg = dataclasses.replace(cfg, num_nodes=ds.num_nodes,
                                      num_steps=ds.num_steps,
                                      checkpoint_blocks=nb)
        pipe = getattr(c.data, "pipeline", None)
        if (pipe is None or pipe.ds is not ds or pipe.nb != nb
                or torch.device(pipe.device) != self.device):
            pipe = DTDGPipeline(ds, nb=nb, device=self.device)
        self._resolved = ResolvedRun(
            config=c, cfg=cfg, ds=ds, pipeline=pipe, plan=c.plan,
            opt_cfg=c.optimizer, seed=c.seed, log_every=c.log_every,
            log_fn=c.log_fn, device=self.device, mesh=mesh,
            padded_from=nominal if n != nominal else None)
        return self._resolved

    def fit(self) -> RunResult:
        rr = self.resolve()
        params = self._params
        if params is not None:
            params = params.to(self.device)
        base = obs.metrics_snapshot()
        trc = obs.get_tracer()
        spans0 = trc.recorded
        self._last = _WORKERS[rr.plan.mode](rr, params)
        self._last.metrics = obs.metrics().delta(base)
        self._last.metrics["spans"] = trc.summary(trc.spans_since(spans0))
        return self._last

    def resume(self) -> RunResult:
        raise NotImplementedError(
            "Engine.resume: checkpointing (ckpt/) is not ported yet "
            "(ROADMAP Queue 1, item 8)")

    def evaluate(self, state: TrainState | RunResult | None = None,
                 test_snapshot=None, theta: float = 0.1,
                 seed: int = 0) -> float:
        """Link-prediction accuracy (paper §6.4) of trained params on the
        held-out ``test_snapshot`` (default: the trace's last snapshot)."""
        rr = self.resolve()
        if state is None:
            if self._last is None:
                raise ValueError("evaluate() before fit(): pass a state")
            state = self._last
        if isinstance(state, RunResult):
            state = state.state
        snap = rr.ds.snapshots[-1] if test_snapshot is None else test_snapshot
        return evaluate_link_prediction(rr.cfg, state.params, rr.pipeline,
                                        snap, theta=theta, seed=seed)
