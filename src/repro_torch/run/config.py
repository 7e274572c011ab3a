"""Run configuration: the one declarative description of a training run
(port of ``repro.run.config``).

``RunConfig`` holds the model config, a :class:`DataSource`, an
:class:`ExecutionPlan`, the optimizer, checkpointing, logging and the
parameter-init ``seed``.  ``Engine.resolve()`` turns it into a
:class:`ResolvedRun`, the bundle the workers consume; ``Engine.fit()``
returns a :class:`RunResult`.  Checkpointing (``CheckpointSpec``; the
reference's ``ckpt/``) is not ported yet: a run that asks for it is
refused (ROADMAP Queue 1, item 8).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.core.models import DynGNNConfig
from repro_torch.data.dyngnn import DTDGDataset, DTDGPipeline
from repro_torch.hoststore.sampled import SampleReport
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.run.data import DataSource
from repro_torch.run.plan import ExecutionPlan
from repro_torch.stream.encoder import StreamReport
from repro_torch.train.trainer import TrainState


@dataclass(frozen=True)
class CheckpointSpec:
    """Where/how often to checkpoint (refused until ROADMAP Queue 1,
    item 8 ports ``ckpt/``)."""

    directory: str
    every: int = 50


@dataclass(frozen=True)
class RunConfig:
    model: DynGNNConfig
    data: DataSource
    plan: ExecutionPlan = ExecutionPlan()
    optimizer: AdamWConfig | None = None      # None = schedule default
    checkpoint: CheckpointSpec | None = None
    seed: int = 0                             # param-init generator seed
    log_every: int = 10
    log_fn: Callable[[str], None] = print


@dataclass
class ResolvedRun:
    """Everything a worker needs, resolved once.  ``mesh`` is the run's
    process group (None on one device); ``padded_from`` the nominal
    ``num_nodes`` when the plan padded the vertex axis.  ``cache`` holds
    the step functions so repeated ``fit()`` calls reuse them."""

    config: RunConfig
    cfg: DynGNNConfig               # model config w/ resolved N and T
    ds: DTDGDataset
    pipeline: DTDGPipeline
    plan: ExecutionPlan
    opt_cfg: AdamWConfig | None
    seed: int
    log_every: int
    log_fn: Callable[[str], None]
    device: torch.device
    mesh: Any = None                # torch.distributed group, or None
    padded_from: int | None = None  # original num_nodes if auto-padded
    cache: dict = field(default_factory=dict)


@dataclass
class RunResult:
    """What ``Engine.fit()`` returns: the final state, the per-step
    (eager, streamed) or per-round (streamed_mesh) loss stream, the
    graph-diff byte accounting (``transfer_report``), the streamed
    schedule's encoder health counters (``stream_report``: resyncs when
    live churn outgrows the measured pads), the per-rank stream payloads of
    the streamed_mesh schedule (``per_shard_bytes``), the ``a2a_chunks`` /
    ``pipeline_rounds`` the run executed with (pure schedule knobs: results
    that differ only there carry identical losses), its ``compression``
    (not a pure schedule knob: quantized runs drift within the bound the
    tests pin; "none" is bit-identical) and the ``repro_torch.obs``
    counter delta plus span summary of the fit (``metrics``; the
    partitioned schedules' ``partition.a2a_*`` counters among them), the
    sampled schedule's ``sample_report`` (``hoststore.SampleReport``: rounds,
    staged bytes, dropped lanes, host sampling and step seconds) and, when
    the plan sets ``device_budget_bytes``, the ``budget_report``
    (``{"required": ..., "budget": ...}`` of the schedule's resident graph
    tensors).  The reference's ``rescale_report`` arrives with the elastic
    loop."""

    state: TrainState
    losses: list[float]
    stream_report: StreamReport | None = None
    transfer_report: dict | None = None
    per_shard_bytes: list[int] | None = None
    a2a_chunks: int = 1
    pipeline_rounds: bool = False
    compression: str = "none"
    sample_report: SampleReport | None = None
    budget_report: dict | None = None
    metrics: dict | None = None     # obs counter delta + span summary
