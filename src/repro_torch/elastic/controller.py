"""Rescale policy: WHEN the snapshot-parallel width changes, and to what
(port of ``repro.elastic.controller``; host-only, copied).

The controller is pure decision logic — no meshes, no device state.  It
consumes two event sources and answers one question per checkpoint-block
boundary ("what width should the next block train under?"):

* a scripted ``schedule`` of ``(block, new_p)`` pairs — the deterministic
  source tests, benchmarks, and the launcher's ``--rescale-at`` use.
  ``block`` is the GLOBAL round index (rounds count across epochs; one
  round = one checkpoint block) at which the new width takes effect;
* a :class:`repro_torch.ft.elastic.PreemptionGuard` — when SIGTERM fires and
  ``shrink_to`` is set, the controller absorbs the capacity loss by
  shrinking to that width at the NEXT boundary instead of stopping;
  without ``shrink_to`` the flag tells the training loop to
  checkpoint-and-exit cleanly (classic preemption).

Either way a change is only ever REALIZED at a block boundary.  That
deferral is what makes elasticity cheap here: the per-shard delta
streams open every block slice with a self-contained ``FullSnapshot``,
so no decoder state crosses a boundary, and the only state that has to
move is the block-boundary temporal carries plus (when growing) the
replicated train state — see ``repro_torch.elastic.reshard`` and
``repro_torch.dist.comm_volume.rescale_payload``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.ft.elastic import PreemptionGuard


@dataclass(frozen=True)
class RescaleEvent:
    """One EXECUTED rescale, recorded on the :class:`RescaleReport`."""

    block: int          # global round (= checkpoint-block) boundary
    old_p: int
    new_p: int
    payload_bytes: int  # re-shard bytes (== comm_volume.rescale_payload)
    # wall time actually paid at this boundary: state re-shard + (only
    # the FIRST time a width appears) the per-width stream encode — an
    # amortized cost; later boundaries of the same width slice the
    # runtime's cached encoding for free (ElasticRuntime.shard_streams)
    recompose_s: float
    cause: str = "scheduled"        # "scheduled" | "preemption"


@dataclass
class RescaleReport:
    """What ``Engine.fit`` records about an elastic run.

    ``events`` are the realized rescales in order; ``segments`` the
    ``(start_block, width, per_shard_bytes)`` stream accounting of every
    constant-width stretch (the segment's PLANNED slice payload — a
    preempted segment may stop before streaming its tail); ``preempted``
    is True when the run stopped on SIGTERM (checkpointed, resumable);
    ``resumed_from`` the global round a resumed run continued at (None
    for fresh runs).
    """

    events: list = field(default_factory=list)
    segments: list = field(default_factory=list)
    preempted: bool = False
    resumed_from: int | None = None

    @property
    def widths(self) -> list[int]:
        """Width trajectory: initial width followed by each new_p."""
        if not self.events and not self.segments:
            return []
        first = (self.segments[0][1] if self.segments
                 else self.events[0].old_p)
        return [first] + [e.new_p for e in self.events]


def validate_schedule(schedule) -> tuple:
    """Normalize + validate a scripted resize schedule.

    THE one rule set for ``(block, new_p)`` scripts —
    ``ExecutionPlan.validate`` and ``RescaleController`` both call it,
    so the Engine surface and the direct API can never drift apart.
    Returns the normalized ``((block, new_p), ...)`` tuple.
    """
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


class RescaleController:
    """Decides the snapshot-parallel width at every block boundary."""

    def __init__(self, initial_p: int, schedule=(),
                 guard: PreemptionGuard | None = None,
                 shrink_to: int | None = None):
        if initial_p < 1:
            raise ValueError(f"initial_p must be >= 1, got {initial_p}")
        if shrink_to is not None and shrink_to < 1:
            raise ValueError(f"shrink_to must be >= 1, got {shrink_to}")
        self.initial_p = int(initial_p)
        self.schedule: tuple = validate_schedule(schedule)
        self.guard = guard
        self.shrink_to = shrink_to
        self._shrunk = False

    # ------------------------------------------------------- queries ------

    @property
    def widths(self) -> tuple[int, ...]:
        """Every width this controller can ask for (validation input)."""
        ws = (self.initial_p,) + tuple(p for _, p in self.schedule)
        if self.shrink_to is not None:
            ws += (self.shrink_to,)
        return ws

    def scripted_width(self, block: int) -> int:
        """Width the schedule alone prescribes for ``block``."""
        p = self.initial_p
        for b, new_p in self.schedule:
            if b <= block:
                p = new_p
        return p

    def width_at(self, block: int, current_p: int) -> tuple[int, str]:
        """(width to train block under, cause).  A pending preemption
        shrink is realized here — once, and it then sticks (a lost pod
        does not come back because the script said so).  Absorbing the
        shrink CLEARS the guard's flag so a SECOND SIGTERM re-arms
        ``interrupt``/``should_stop`` — already at the shrink width,
        the only remaining graceful answer is checkpoint-and-exit.
        A shrink only absorbs when it actually SHRINKS: at or above the
        current width it would be a silent no-op, so ``should_stop``
        treats that signal as unabsorbable instead."""
        if (self.guard is not None and self.guard.preempted
                and self.shrink_to is not None and not self._shrunk
                and self.shrink_to < current_p):
            self._shrunk = True
            self.guard.preempted = False
        if self._shrunk:
            return min(self.shrink_to, current_p), "preemption"
        return self.scripted_width(block), "scheduled"

    def next_boundary(self, block: int) -> int | None:
        """Next scripted boundary strictly after ``block`` (None = none)."""
        for b, _ in self.schedule:
            if b > block:
                return b
        return None

    # ------------------------------------------------- interruptions ------

    def interrupt(self) -> bool:
        """True when the running segment should stop at the next block
        boundary: SIGTERM arrived and has not been absorbed yet
        (``width_at`` clears the flag when a shrink absorbs it)."""
        return self.guard is not None and self.guard.preempted

    def should_stop(self, current_p: int | None = None) -> bool:
        """True when the run should checkpoint-and-exit: SIGTERM with no
        shrink width left to absorb it — none configured, the one shrink
        already spent on an earlier signal, or (when ``current_p`` is
        given) a shrink target at/above the current width, which could
        only no-op."""
        if self.guard is None or not self.guard.preempted:
            return False
        if self.shrink_to is None or self._shrunk:
            return True
        return current_p is not None and self.shrink_to >= current_p
