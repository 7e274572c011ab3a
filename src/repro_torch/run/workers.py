"""The training worker behind ``Engine.fit()`` (port of the eager part of
``repro.run.workers``).

``fit_eager`` is the blocked single-device trainer: the step from
``train.trainer.make_single_device_train_step`` run ``plan.num_steps``
times over the pipeline's batch, with each step in a fenced ``train.step``
span when tracing is on.  The reference's async checkpointing, preemption
guard and straggler timer (``ckpt/``, ``ft/``) are not ported yet (ROADMAP
Queue 1, item 8); nor are the other schedules' workers.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core import models as dyn_models
from repro_torch.optim import adamw
from repro_torch.run.config import ResolvedRun, RunResult
from repro_torch.train import trainer


def fit_eager(rr: ResolvedRun, params=None) -> RunResult:
    """``params``: initial parameters (a ``ParamTree`` on the run's
    device, updated in place); drawn from ``rr.seed`` when None."""
    num_steps = rr.plan.num_steps
    opt_cfg = rr.opt_cfg or adamw.AdamWConfig(
        lr=1e-2, warmup_steps=10, total_steps=num_steps, weight_decay=0.0)
    if params is None:
        params = dyn_models.init_params(
            torch.Generator().manual_seed(rr.seed), rr.cfg).to(rr.device)
    opt_state = adamw.init_state(params)
    step_fn = rr.cache.get("eager_step")
    if step_fn is None:
        step_fn = trainer.make_single_device_train_step(rr.cfg, opt_cfg)
        rr.cache["eager_step"] = step_fn
    batch = rr.pipeline.batch
    labels = torch.from_numpy(rr.ds.labels).to(batch.frames.device)

    losses: list[float] = []
    for step in range(num_steps):
        with obs.span("train.step", step=step) as sp:
            params, opt_state, loss = step_fn(params, opt_state, batch,
                                              labels)
            sp.fence(loss)
        losses.append(float(loss))
        if step % rr.log_every == 0:
            rr.log_fn(f"step {step} loss {float(loss):.4f}")
    state = trainer.TrainState(params=params, opt_state=opt_state,
                               step=len(losses))
    return RunResult(state=state, losses=losses,
                     transfer_report=rr.pipeline.transfer_bytes())
