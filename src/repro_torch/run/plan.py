"""Execution plans: the *how* of a training run (port of ``repro.run.plan``).

The fields are the reference's.  Ported: ``eager`` (the blocked trainer;
on P > 1 shards, or on an explicit process group, snapshot-partitioned,
with ``mesh_axis``, ``a2a_chunks`` and ``auto_pad``), ``streamed``
(per-snapshot training over the delta stream, with ``num_epochs``,
``overlap`` and ``prefetch_depth``) and ``streamed_mesh`` (per-rank delta
streams under snapshot partitioning, with ``a2a_chunks``,
``pipeline_rounds`` and ``compression``; the timeline re-blocked for P by
:meth:`ExecutionPlan.resolved_blocks`) and ``sampled`` (out-of-core
fanout-sampled training over the host-resident store, ``hoststore``,
with ``sampling``; the vertex axis never padded: the round table is).
``device_budget_bytes`` gates every mode against the simulated
per-device graph budget (``hoststore.budget``).
:meth:`ExecutionPlan.validate` applies the reference's rules and then
refuses what is not ported yet, naming the ROADMAP item that ports it:
the elastic ``rescale`` / ``rescale_on_preempt`` — Queue 1, item 8.

The reference's mesh is a ``torch.distributed`` process group here, one
process per rank (gloo on the CPU, NCCL on the card with rank r on
``cuda:r``): ``mesh`` takes a group, and ``num_shards`` is its size.  A
group of any size, 1 included, runs the partitioned step, as a prebuilt
mesh does in the reference.  ``shards = P`` without a group uses the
default group when it is initialized with P ranks (``torchrun
--nproc-per-node P``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import DATA_AXIS, group_size
from repro_torch.ft.elastic import dyngnn_elastic_blocks
from repro_torch.hoststore.spec import SamplingSpec

MODES = ("eager", "streamed", "streamed_mesh", "sampled")
COMPRESSIONS = ("none", "int8_a2a", "int8_all")


def _validate_schedule(schedule) -> tuple:
    """The reference's rule set for a ``((block, new_p), ...)`` resize
    script (``repro.elastic.controller.validate_schedule``), normalized."""
    events = []
    last = 0
    for entry in schedule:
        try:
            b, p = entry
        except (TypeError, ValueError):
            raise ValueError(
                f"rescale schedule entries must be (block, new_p) "
                f"pairs, got {entry!r}") from None
        b, p = int(b), int(p)
        if b < 1:
            raise ValueError(
                f"rescale boundaries start at block 1 (block 0 is the "
                f"initial width), got {b}")
        if b <= last:
            raise ValueError(
                "rescale boundaries must be strictly increasing, got "
                f"block {b} after {last}")
        if p < 1:
            raise ValueError(f"rescale width must be >= 1, got {p}")
        events.append((b, p))
        last = b
    return tuple(events)


@dataclass(frozen=True)
class ExecutionPlan:
    """Declarative execution spec, independent of model and data.

    ``shards`` is the snapshot-parallel width; ``mesh`` may inject a
    process group instead (its one axis is ``mesh_axis``, "data").
    ``num_steps`` drives the eager schedule, ``num_epochs`` the streamed
    ones.  The overlap, compression and
    rescale knobs belong to the streamed schedules (see
    ``repro.run.plan``); ``sampling`` holds the sampled schedule's spec.
    """

    mode: str = "eager"             # eager|streamed|streamed_mesh|sampled
    shards: int = 1
    mesh: Any = None
    mesh_axis: str = "data"
    num_steps: int = 100            # eager schedule length
    num_epochs: int = 1             # streamed passes over the trace
    overlap: bool = True
    prefetch_depth: int = 2
    a2a_chunks: int = 1             # chunked all-to-alls (partitioned)
    pipeline_rounds: bool = False   # round-level pipelining (streamed_mesh)
    compression: str = "none"       # wire compression (streamed_mesh)
    auto_pad: bool = True
    rescale: tuple = ()             # ((block, new_p), ...) resize script
    rescale_on_preempt: int = 0     # SIGTERM shrink-to width (0 = off)
    sampling: SamplingSpec | None = None    # sampled-schedule knobs
    device_budget_bytes: int | None = None  # simulated per-device budget

    def validate(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"plan.mode must be one of {MODES}, "
                             f"got {self.mode!r}")
        if self.mode == "sampled" and self.sampling is None:
            raise ValueError("mode='sampled' needs plan.sampling="
                             "SamplingSpec(batch_nodes, fanouts, ...)")
        if self.sampling is not None:
            if self.mode != "sampled":
                raise ValueError("plan.sampling configures the sampled "
                                 "schedule; it requires mode='sampled' "
                                 f"(got {self.mode!r})")
            self.sampling.validate()
        if (self.device_budget_bytes is not None
                and self.device_budget_bytes < 1):
            raise ValueError("plan.device_budget_bytes must be >= 1 "
                             "bytes (None = unlimited)")
        if self.shards < 1:
            raise ValueError(f"plan.shards must be >= 1, got {self.shards}")
        if self.prefetch_depth < 1:
            raise ValueError("plan.prefetch_depth must be >= 1")
        if self.a2a_chunks < 1:
            raise ValueError(f"plan.a2a_chunks must be >= 1, "
                             f"got {self.a2a_chunks}")
        if self.mode == "streamed" and (self.shards > 1
                                        or self.mesh is not None):
            raise ValueError("mode='streamed' is single-device; use "
                             "mode='streamed_mesh' for snapshot-parallel "
                             "streaming")
        if self.a2a_chunks > 1 and not self.partitioned:
            raise ValueError("plan.a2a_chunks chunks the partitioned "
                             "schedule's all-to-alls; this plan runs "
                             f"without a process group (mode={self.mode!r},"
                             f" shards={self.num_shards}) so there are "
                             "none — use shards > 1 or pass mesh=group")
        if self.partitioned and self.mesh_axis != DATA_AXIS:
            raise ValueError(f"plan.mesh_axis={self.mesh_axis!r}: a process "
                             f"group has the one axis {DATA_AXIS!r}")
        if self.pipeline_rounds and self.mode != "streamed_mesh":
            raise ValueError("plan.pipeline_rounds pipelines the "
                             "distributed streamed round loop; it requires "
                             "mode='streamed_mesh'")
        if self.compression not in COMPRESSIONS:
            raise ValueError(f"plan.compression must be one of "
                             f"{COMPRESSIONS}, got {self.compression!r}")
        if self.compression != "none":
            if self.mode != "streamed_mesh":
                raise ValueError(
                    "plan.compression quantizes the distributed stream's "
                    "wire formats (the all-to-alls and the host->device "
                    "deltas); it requires mode='streamed_mesh' "
                    f"(got {self.mode!r})")
            if self.is_elastic:
                raise ValueError(
                    "plan.compression is not wired through the elastic "
                    "segment loop (error-feedback residuals would need "
                    "re-sharding at every rescale boundary); drop "
                    "rescale/rescale_on_preempt or use compression='none'")
        if self.rescale_on_preempt < 0:
            raise ValueError("plan.rescale_on_preempt is a shrink-to "
                             "width (0 = off); it cannot be negative")
        if ((self.rescale or self.rescale_on_preempt)
                and self.mode != "streamed_mesh"):
            raise ValueError("plan.rescale/rescale_on_preempt recompose "
                             "the distributed stream at checkpoint-block "
                             "boundaries; they require "
                             "mode='streamed_mesh'")
        if self.rescale:
            _validate_schedule(self.rescale)
        self._refuse_unported()

    def _refuse_unported(self) -> None:
        if self.is_elastic:
            raise NotImplementedError(
                "plan.rescale/rescale_on_preempt: the elastic segment loop "
                "(elastic/, ft/elastic.PreemptionGuard) is not ported yet "
                "(ROADMAP Queue 1, item 8)")

    @property
    def is_elastic(self) -> bool:
        """True when this plan can change width mid-run."""
        return bool(self.rescale) or self.rescale_on_preempt > 0

    @property
    def num_shards(self) -> int:
        if self.mesh is not None:
            return group_size(self.mesh)
        return self.shards

    @property
    def wants_mesh(self) -> bool:
        """True when this plan trains on a group of num_shards > 1 ranks."""
        return (self.mode in ("streamed_mesh", "sampled")
                or (self.mode == "eager" and self.num_shards > 1))

    @property
    def partitioned(self) -> bool:
        """True when the eager step runs snapshot-partitioned: on more
        than one shard, or on an explicit group of any size."""
        return self.wants_mesh or self.mesh is not None

    def build_mesh(self):
        """The plan's process group, or None for one device: ``mesh``
        when given; else, for P > 1 shards, the default group, which must
        be initialized with P ranks."""
        if self.mesh is not None:
            return self.mesh
        if not self.wants_mesh:
            return None
        p = self.num_shards
        if not dist.is_initialized() or dist.get_world_size() != p:
            have = (f"{dist.get_world_size()} ranks" if dist.is_initialized()
                    else "no process group")
            flag = {"streamed_mesh": f"--stream --mesh {p}",
                    "sampled": f"--sampled --mesh {p}"}.get(
                        self.mode, f"--data-parallel {p}")
            raise ValueError(
                f"plan.shards={p} needs a process group of {p} ranks and "
                f"there is {have}: launch one process per rank (torchrun "
                f"--nproc-per-node {p} -m repro_torch.launch.train "
                f"{flag} ...) or pass mesh=group")
        return dist.group.WORLD

    def check_devices(self, device: torch.device) -> None:
        """NCCL runs one rank per card: refuse a partitioned plan on CUDA
        with fewer visible cards than ranks (never a fallback)."""
        if device.type != "cuda" or not self.wants_mesh:
            return
        have = torch.cuda.device_count()
        if have < self.num_shards:
            raise RuntimeError(
                f"{self.num_shards} snapshot-parallel ranks on cuda need "
                f"{self.num_shards} visible CUDA devices (one per rank); "
                f"{have} visible")

    def padded_num_nodes(self, num_nodes: int,
                         log_fn: Callable[[str], None] | None = None) -> int:
        """``num_nodes`` rounded up to the next multiple of the ranks.

        The vertex-sharded temporal stage needs N % P == 0; rather than
        refusing to run, the plan pads the vertex axis with isolated nodes
        and logs the padding (``auto_pad=False`` refuses instead).  The
        sampled schedule's temporal stage runs over the round node TABLE,
        which ``SamplingSpec.resolve`` pads to the ranks, so its vertex
        axis never has to divide.  The reference's elastic plans pad to
        the lcm of their widths; they wait for ROADMAP Queue 1, item 8.
        """
        p = self.num_shards
        if self.mode == "sampled":
            return num_nodes
        if not self.wants_mesh or num_nodes % p == 0:
            return num_nodes
        if not self.auto_pad:
            raise ValueError(f"num_nodes {num_nodes} must divide over "
                             f"{p} shards (set plan.auto_pad=True to pad)")
        padded = ((num_nodes + p - 1) // p) * p
        if log_fn is not None:
            log_fn(f"plan: auto-padding num_nodes {num_nodes} -> {padded} "
                   f"(next multiple of {p} shards)")
        return padded

    def resolved_blocks(self, num_steps: int, checkpoint_blocks: int,
                        log_fn: Callable[[str], None] | None = None) -> int:
        """Checkpoint-block count adjusted for the streamed mesh.

        ``streamed_mesh`` and ``sampled`` need ``bsize % P == 0`` and
        ``T % bsize == 0`` (each round is one block, sliced over the
        shards).  When the requested blocking violates that, re-block via
        ``ft.elastic.dyngnn_elastic_blocks`` (largest legal block <= the
        requested one) and log the adjustment.
        """
        if self.mode not in ("streamed_mesh", "sampled"):
            return checkpoint_blocks
        p = self.num_shards
        nb = max(checkpoint_blocks, 1)
        bsize = num_steps // nb
        if bsize >= 1 and num_steps % bsize == 0 and bsize % p == 0:
            return nb
        if num_steps % p:
            raise ValueError(
                f"trace length {num_steps} cannot be sliced over {p} "
                "snapshot shards (num_steps % shards != 0)")
        nb2, bsize2 = dyngnn_elastic_blocks(num_steps, p, max(bsize, p))
        if log_fn is not None:
            log_fn(f"plan: re-blocking timeline for {p} shards: "
                   f"checkpoint_blocks {checkpoint_blocks} -> {nb2} "
                   f"(block size {bsize2})")
        return nb2
