"""Execution plans: the *how* of a training run (port of ``repro.run.plan``).

The fields are the reference's.  The single-device schedules are ported:
``eager`` (the blocked trainer) and ``streamed`` (per-snapshot training
over the delta stream, with ``num_epochs``, ``overlap`` and
``prefetch_depth``).  :meth:`ExecutionPlan.validate` applies the
reference's rules and then refuses what is not ported yet, naming the
ROADMAP item that ports it:

* ``eager`` on more than one shard (snapshot partitioning) — Queue 1, item 5;
* ``streamed_mesh`` (with its overlap, compression and rescale knobs) —
  Queue 1, item 7;
* ``sampled`` and ``device_budget_bytes`` (``hoststore``) — Queue 1, item 8.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

MODES = ("eager", "streamed", "streamed_mesh", "sampled")
COMPRESSIONS = ("none", "int8_a2a", "int8_all")

#: mode -> the ROADMAP item that ports it
_NOT_PORTED = {"streamed_mesh": "Queue 1, item 7",
               "sampled": "Queue 1, item 8"}


@dataclass(frozen=True)
class ExecutionPlan:
    """Declarative execution spec, independent of model and data.

    ``shards`` is the snapshot-parallel width; ``mesh`` may inject a
    prebuilt mesh instead.  ``num_steps`` drives the eager schedule,
    ``num_epochs`` the streamed ones.  The overlap, compression and
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
    a2a_chunks: int = 1             # chunked all-to-alls (mesh schedules)
    pipeline_rounds: bool = False   # round-level pipelining (streamed_mesh)
    compression: str = "none"       # wire compression (streamed_mesh)
    auto_pad: bool = True
    rescale: tuple = ()             # ((block, new_p), ...) resize script
    rescale_on_preempt: int = 0     # SIGTERM shrink-to width (0 = off)
    sampling: Any = None            # sampled-schedule knobs
    device_budget_bytes: int | None = None  # simulated per-device budget

    def validate(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"plan.mode must be one of {MODES}, "
                             f"got {self.mode!r}")
        if self.mode == "sampled" and self.sampling is None:
            raise ValueError("mode='sampled' needs plan.sampling="
                             "SamplingSpec(batch_nodes, fanouts, ...)")
        if self.sampling is not None and self.mode != "sampled":
            raise ValueError("plan.sampling configures the sampled "
                             "schedule; it requires mode='sampled' "
                             f"(got {self.mode!r})")
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
        if self.a2a_chunks > 1 and not self.wants_mesh:
            raise ValueError("plan.a2a_chunks chunks the shard_map "
                             "all-to-alls; this plan runs without a mesh "
                             f"(mode={self.mode!r}, shards="
                             f"{self.num_shards}) so there are none — "
                             "use a mesh schedule")
        if self.pipeline_rounds and self.mode != "streamed_mesh":
            raise ValueError("plan.pipeline_rounds pipelines the "
                             "distributed streamed round loop; it requires "
                             "mode='streamed_mesh'")
        if self.compression not in COMPRESSIONS:
            raise ValueError(f"plan.compression must be one of "
                             f"{COMPRESSIONS}, got {self.compression!r}")
        if self.compression != "none" and self.mode != "streamed_mesh":
            raise ValueError(
                "plan.compression quantizes the distributed stream's "
                "wire formats; it requires mode='streamed_mesh' "
                f"(got {self.mode!r})")
        if self.rescale_on_preempt < 0:
            raise ValueError("plan.rescale_on_preempt is a shrink-to "
                             "width (0 = off); it cannot be negative")
        if ((self.rescale or self.rescale_on_preempt)
                and self.mode != "streamed_mesh"):
            raise ValueError("plan.rescale/rescale_on_preempt recompose "
                             "the distributed stream at checkpoint-block "
                             "boundaries; they require "
                             "mode='streamed_mesh'")
        self._refuse_unported()

    def _refuse_unported(self) -> None:
        if self.mode in _NOT_PORTED:
            raise NotImplementedError(
                f"plan.mode={self.mode!r} is not ported to PyTorch yet "
                f"(ROADMAP {_NOT_PORTED[self.mode]}); the port trains "
                "mode='eager' or 'streamed' on one device")
        if self.wants_mesh:
            raise NotImplementedError(
                f"eager training on {self.num_shards} shards (snapshot "
                "partitioning) is not ported yet (ROADMAP Queue 1, item 5)")
        if self.device_budget_bytes is not None:
            raise NotImplementedError(
                "plan.device_budget_bytes (hoststore/budget) is not ported "
                "yet (ROADMAP Queue 1, item 8)")

    @property
    def num_shards(self) -> int:
        if self.mesh is not None:
            return int(self.mesh.shape[self.mesh_axis])
        return self.shards

    @property
    def wants_mesh(self) -> bool:
        """True when this plan trains under a mesh."""
        return (self.mode in ("streamed_mesh", "sampled")
                or (self.mode == "eager" and self.num_shards > 1))
