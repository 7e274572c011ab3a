"""``repro_torch.elastic`` — rescale the distributed stream mid-run (port
of ``repro.elastic``).

The paper's fixed-volume snapshot distribution makes elasticity cheap:
communication stays O(T*N) at ANY snapshot-parallel width P, so changing
P mid-fit only requires re-blocking the timeline at the next
checkpoint-block boundary and moving the boundary state.

* :class:`~repro_torch.elastic.controller.RescaleController` — consumes
  resize events (a scripted ``(block, new_p)`` schedule and/or a
  ``PreemptionGuard``-driven shrink) and defers every change to the next
  block boundary;
* :mod:`~repro_torch.elastic.reshard` — the width groups of the run's
  pool of processes, and the gather / broadcast that moves carries and
  train state onto a new width, with byte accounting that matches
  ``dist.comm_volume.rescale_payload``;
* :func:`~repro_torch.elastic.train.train_elastic_streamed` — the segment
  loop on ``torch.distributed``: the ranks of the active width train, the
  others wait at the next boundary; checkpoint / resume at round
  granularity onto any legal width.

Engine surface: ``ExecutionPlan(rescale=((block, new_p), ...),
rescale_on_preempt=w)`` and ``RunResult.rescale_report``.  Losses are
invariant under any rescale trajectory (``tests/test_torch_elastic.py``
pins P = 4 -> 8 -> 2 on 8 gloo ranks against the JAX serial reference).
"""

from repro_torch.elastic.controller import (RescaleController, RescaleEvent,
                                            RescaleReport, validate_schedule)
from repro_torch.elastic.reshard import (broadcast_state, gather_carries,
                                         rescale_payload_bytes,
                                         slice_carries, tree_bytes,
                                         width_groups)
from repro_torch.elastic.train import (ElasticRuntime, ElasticStreamState,
                                       train_elastic_streamed,
                                       validate_widths)

__all__ = [
    "ElasticRuntime", "ElasticStreamState", "RescaleController",
    "RescaleEvent", "RescaleReport", "broadcast_state", "gather_carries",
    "rescale_payload_bytes", "slice_carries", "train_elastic_streamed",
    "tree_bytes", "validate_schedule", "validate_widths", "width_groups",
]
