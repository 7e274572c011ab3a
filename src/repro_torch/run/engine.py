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
runs the paper's link-prediction protocol on the trained params;
``resume()`` restarts from the newest checkpoint of the run's
``CheckpointSpec`` (eager and streamed_mesh; a streamed_mesh checkpoint
restores onto any legal width).  ``device`` defaults to ``"cuda"`` and raises without a card unless the
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
        plan = c.plan
        if (c.checkpoint is not None
                and plan.mode not in ("eager", "streamed_mesh")):
            raise ValueError(
                "RunConfig.checkpoint is only wired for plan.mode='eager' "
                f"and 'streamed_mesh' (got {plan.mode!r}); the "
                "single-device streamed schedule does not checkpoint yet "
                "— drop the CheckpointSpec or switch modes")
        if c.checkpoint is not None and plan.compression != "none":
            raise ValueError(
                "RunConfig.checkpoint routes streamed_mesh through the "
                "elastic segment loop, which does not thread the "
                "error-feedback residuals of plan.compression="
                f"{plan.compression!r}; drop the CheckpointSpec or use "
                "compression='none'")
        # an elastic plan's groups are made once its widths are known to
        # be realizable
        mesh = None if plan.is_elastic else plan.build_mesh()
        nominal = c.data.num_nodes
        n = plan.padded_num_nodes(nominal, log_fn=c.log_fn)
        ds = c.data.build(num_nodes=n if n != nominal else None)
        nb = plan.resolved_blocks(ds.num_steps, c.model.checkpoint_blocks,
                                  log_fn=c.log_fn)
        if plan.is_elastic:
            # every width the rescale policy can switch to must slice the
            # resolved block and the (lcm-padded) vertex axis, over the
            # pool's ranks — fail at resolve time, not segments into the run
            from repro_torch.elastic.train import validate_widths
            pool = (torch.distributed.get_world_size()
                    if torch.distributed.is_initialized() else 1)
            validate_widths(plan.rescale_widths, win=ds.num_steps // nb,
                            num_nodes=ds.num_nodes, num_devices=pool)
            mesh = plan.build_mesh()
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
            log_fn=c.log_fn, device=self.device, checkpoint=c.checkpoint,
            mesh=mesh,
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
        """Explicit restart from the configured checkpoint directory.

        streamed_mesh checkpoints hold whole host arrays: the resuming
        plan may use a DIFFERENT snapshot-parallel width than the one the
        checkpoint was written at — the worker slices the restored
        carries for the current ranks and re-slices the remaining delta
        streams from the saved cursor (``repro_torch.elastic``).
        """
        rr = self.resolve()
        if rr.checkpoint is None:
            raise ValueError("resume() needs RunConfig.checkpoint")
        if rr.plan.mode not in ("eager", "streamed_mesh"):
            raise NotImplementedError("checkpoint resume is only wired for "
                                      "the eager and streamed_mesh "
                                      "schedules")
        from repro_torch.ckpt.checkpoint import Checkpointer
        if Checkpointer(rr.checkpoint.directory).latest_step() is None:
            raise FileNotFoundError(
                f"no checkpoint under {rr.checkpoint.directory}")
        return self.fit()

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
