"""Per-device graph-tensor budget gating (a copy of
``repro.hoststore.budget``).

``ExecutionPlan.device_budget_bytes`` simulates a device memory cap for
the GRAPH-SHAPED tensors a schedule keeps resident per round (edges +
mask + values + features + labels — the terms that scale with N and E;
params/optimizer/activations are schedule-independent and excluded so
the comparison isolates what sampling changes).

Full-graph schedules must materialize their whole time slice of every
round at full N / full E_max, so their requirement scales with the
graph; the sampled schedule stages O(table_pad + edge_pad) instead.  A
budget between the two is the out-of-core regime: the full schedules
REFUSE (raise :class:`DeviceBudgetError` at fit time, before anything
is allocated), the sampled schedule proceeds.
"""

from __future__ import annotations

from repro_torch.hoststore.spec import ResolvedSampling

# int32 (src,dst) + f32 mask + f32 values per edge lane
_EDGE_LANE = 8 + 4 + 4


class DeviceBudgetError(RuntimeError):
    """A schedule's resident graph tensors exceed the simulated budget."""

    def __init__(self, mode: str, required: int, budget: int):
        self.mode, self.required, self.budget = mode, required, budget
        super().__init__(
            f"schedule {mode!r} needs {required} bytes of per-device "
            f"graph tensors but plan.device_budget_bytes={budget}; the "
            "full per-snapshot tensors do not fit — use "
            "schedule='sampled' (out-of-core fanout sampling)")


def full_graph_round_bytes(mode: str, *, num_steps: int, win: int,
                           num_shards: int, max_edges: int, num_nodes: int,
                           feat_dim: int) -> int:
    """Per-device resident graph bytes of a full-graph schedule.

    eager holds the whole blocked batch (its time axis sharded on a
    mesh); the streamed schedules hold one round (``win`` steps, over
    ``num_shards`` for the mesh variant) reconstructed at full width.
    """
    per_step = (max_edges * _EDGE_LANE + num_nodes * feat_dim * 4
                + num_nodes * 4)
    if mode == "eager":
        return (num_steps // max(num_shards, 1)) * per_step
    if mode == "streamed":
        return win * per_step
    if mode == "streamed_mesh":
        return (win // num_shards) * per_step
    raise ValueError(f"no budget model for mode {mode!r}")


def sampled_round_bytes(resolved: ResolvedSampling, *, win: int,
                        num_shards: int, feat_dim: int) -> int:
    """Per-device resident graph bytes of one sampled round."""
    per_step = (resolved.edge_pad * _EDGE_LANE
                + resolved.table_pad * feat_dim * 4
                + resolved.table_pad * 4)
    return (win // num_shards) * per_step


def check_budget(mode: str, budget: int | None, *, num_steps: int,
                 win: int, num_shards: int, max_edges: int, num_nodes: int,
                 feat_dim: int,
                 resolved: ResolvedSampling | None = None) -> dict | None:
    """Gate one schedule against the simulated budget.

    Returns ``{"required": ..., "budget": ...}`` (None when no budget is
    set); raises :class:`DeviceBudgetError` when the schedule's resident
    graph tensors do not fit.
    """
    if budget is None:
        return None
    if mode == "sampled":
        if resolved is None:
            raise ValueError("sampled budget check needs the resolved "
                             "sampling shapes")
        required = sampled_round_bytes(resolved, win=win,
                                       num_shards=num_shards,
                                       feat_dim=feat_dim)
    else:
        required = full_graph_round_bytes(
            mode, num_steps=num_steps, win=win, num_shards=num_shards,
            max_edges=max_edges, num_nodes=num_nodes, feat_dim=feat_dim)
    if required > budget:
        raise DeviceBudgetError(mode, required, budget)
    return {"required": required, "budget": budget}
