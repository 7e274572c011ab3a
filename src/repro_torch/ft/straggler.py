"""Straggler mitigation (port of ``repro.ft.straggler``; host-only,
copied).

Synchronous SPMD training runs at the speed of the slowest chip.  Two
mechanisms, both host-side (they orchestrate, not compute):

  * ``StepTimer`` — EWMA step-time watchdog; flags a step as straggling when
    it exceeds mean + k*std.  At scale the launcher uses consecutive flags to
    trigger (a) input-pipeline rebalancing or (b) checkpoint + exclusion of
    the slow host via elastic re-mesh (``ft.elastic``).
  * ``BackupShardSchedule`` — speculative backup execution plan for the
    paper's snapshot partitioning: because the snapshot axis is perfectly
    regular, a backup worker can mirror the k slowest workers' shards cheaply
    (shard reassignment is a cursor change, not a data-layout change).  This
    regularity is exactly the §4.2 advantage; hypergraph partitions would
    need a full re-partition.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from repro_torch import obs


class StepTimer:
    """EWMA step-time watchdog.

    Keeps exponentially weighted moving estimates of the step-time mean
    and variance with smoothing factor ``alpha = 2 / (window + 1)`` (the
    span convention, so ``window`` keeps its old meaning: roughly how
    many recent steps dominate the estimate).  A step is flagged when
    ``dt > mean + threshold_std * sqrt(var)`` once ``min_steps``
    observations have seeded the estimate; the estimate is updated
    *after* the check so an outlier cannot mask itself.  The incremental
    variance update is the standard EW form::

        diff  = dt - mean
        mean += alpha * diff
        var   = (1 - alpha) * (var + alpha * diff**2)

    ``times`` still holds the last ``window`` raw durations — the
    ``BackupShardSchedule`` planner wants the raw tail, not the
    smoothed moments.
    """

    def __init__(self, window: int = 50, threshold_std: float = 3.0,
                 min_steps: int = 10):
        self.window = window
        self.threshold_std = threshold_std
        self.min_steps = min_steps
        self.alpha = 2.0 / (window + 1)
        self.mean = 0.0
        self.var = 0.0
        self.times: deque[float] = deque(maxlen=window)
        self._t0: float | None = None
        self.flagged_steps: list[int] = []
        self.step_idx = 0

    def __enter__(self):
        self._t0 = obs.now_s()
        return self

    def __exit__(self, *exc):
        dt = obs.now_s() - self._t0
        self.observe(dt)
        return False

    def observe(self, dt: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        self.step_idx += 1
        flag = False
        if self.step_idx > self.min_steps:
            std = max(self.var ** 0.5, 1e-9)
            if dt > self.mean + self.threshold_std * std:
                flag = True
                self.flagged_steps.append(self.step_idx)
                obs.inc("straggler.flags")
        if self.step_idx == 1:
            self.mean = dt
            self.var = 0.0
        else:
            diff = dt - self.mean
            incr = self.alpha * diff
            self.mean += incr
            self.var = (1.0 - self.alpha) * (self.var + diff * incr)
        self.times.append(dt)
        return flag

    def reset(self) -> None:
        """Forget all state — e.g. after an elastic re-mesh changes the
        expected step time."""
        self.mean = 0.0
        self.var = 0.0
        self.times.clear()
        self.flagged_steps.clear()
        self.step_idx = 0
        self._t0 = None

    @property
    def straggler_rate(self) -> float:
        return len(self.flagged_steps) / max(self.step_idx, 1)


@dataclass
class BackupShardSchedule:
    """Assign backup workers to the slowest primaries (snapshot shards)."""
    num_workers: int
    num_backups: int
    assignments: dict = field(default_factory=dict)

    def plan(self, step_times: list[float]) -> dict[int, int]:
        """worker -> backup mapping for the k slowest workers."""
        order = sorted(range(self.num_workers),
                       key=lambda w: -step_times[w])
        slowest = order[:self.num_backups]
        self.assignments = {w: self.num_workers + i
                            for i, w in enumerate(slowest)}
        return self.assignments

    def shard_for(self, worker: int, bsize_local: int) -> tuple[int, int]:
        """Snapshot-shard cursor (start, len) — identical for the backup,
        which is the point: re-assignment is O(1) metadata."""
        return worker * bsize_local, bsize_local
