"""Model-vs-measured calibration for the distributed round.

The port's copy of ``repro.obs.calibrate``, over the port's own
``dist/overlap.round_time_model``.

``dist/overlap.round_time_model`` predicts one round from four phase
times (transfer / spatial / a2a / temporal).  A traced ``streamed_mesh``
run *measures* those same phases per round (``round.transfer`` is fenced
wall time; spatial / a2a / temporal come from the comp-ref probe in
``stream/distributed.py``).  ``calibration_report`` joins the two:

* feed each round's measured phases through the model and compare the
  prediction against the measured ``round`` span (the residual tells
  you how much round time the four-phase model fails to explain —
  Python-side reconstruction, dispatch, logging);
* compare each round's phases against the cross-round median baseline
  (per-phase residuals locate *which* phase a straggler round lost
  time in — the signal ROADMAP's policy-driven elasticity needs).

A fenced trace serializes the schedule, so the prediction uses the
model's ``serial_s`` by default; pass ``schedule="pipelined"`` only for
traces captured without fencing (dispatch-timed, not execution-timed).

Works on live ``Tracer`` spans or on a trace file round-tripped through
``obs.export`` — both reduce to (name, dur, round-attr) triples.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable

from repro_torch.dist.overlap import round_time_model

__all__ = ["PHASES", "CalibrationRow", "CalibrationReport",
           "phase_durations", "calibration_report"]

#: The four model phases, in schedule order.  Span names are
#: ``round.<phase>``; the enclosing measured round span is ``round``.
PHASES = ("transfer", "spatial", "a2a", "temporal")


@dataclass
class CalibrationRow:
    """One round's measured phases joined against the model."""
    round: int
    measured_s: dict[str, float]          # phase -> measured seconds
    measured_round_s: float               # the enclosing `round` span
    predicted_s: float                    # model on this round's phases
    residual_s: float                     # measured_round - predicted
    phase_residual_s: dict[str, float]    # phase - cross-round median

    @property
    def rel_residual(self) -> float:
        return self.residual_s / self.predicted_s if self.predicted_s else 0.0


@dataclass
class CalibrationReport:
    """Per-round predicted-vs-measured residuals + baseline medians."""
    rows: list[CalibrationRow]
    baseline_s: dict[str, float]          # median phase times
    schedule: str = "serial"
    chunks: int = 1
    pipeline_rounds: bool = False
    a2a_wire_ratio: float = 1.0
    extra: dict[str, Any] = field(default_factory=dict)

    def summary(self) -> str:
        lines = [f"calibration ({self.schedule} model, C={self.chunks}, "
                 f"pipelined={self.pipeline_rounds}): "
                 f"{len(self.rows)} rounds"]
        base = " ".join(f"{p}={self.baseline_s.get(p, 0.0) * 1e3:.2f}ms"
                        for p in PHASES)
        lines.append(f"  baseline medians: {base}")
        for row in self.rows:
            lines.append(
                f"  round {row.round}: measured={row.measured_round_s * 1e3:.2f}ms "
                f"predicted={row.predicted_s * 1e3:.2f}ms "
                f"residual={row.residual_s * 1e3:+.2f}ms "
                f"({row.rel_residual * 100:+.1f}%)")
        return "\n".join(lines)


def _median(vals: list[float]) -> float:
    if not vals:
        return 0.0
    vals = sorted(vals)
    n = len(vals)
    mid = n // 2
    return vals[mid] if n % 2 else 0.5 * (vals[mid - 1] + vals[mid])


def _as_triples(source: Iterable[Any]) -> list[tuple[str, float, int | None]]:
    """Spans or chrome-trace event dicts -> (name, dur_s, round)."""
    out = []
    for item in source:
        if isinstance(item, dict):
            if item.get("ph") != "X":
                continue
            name = item.get("name", "")
            dur_s = float(item.get("dur", 0.0)) * 1e-6
            rnd = item.get("args", {}).get("round")
        else:
            name = item.name
            dur_s = item.dur_s
            rnd = item.attrs.get("round")
        out.append((name, dur_s, rnd))
    return out


def phase_durations(source: Iterable[Any]) -> dict[int, dict[str, float]]:
    """Group phase + round spans by round index:
    ``{round: {"transfer": s, ..., "round": s}}``."""
    per_round: dict[int, dict[str, float]] = {}
    for name, dur_s, rnd in _as_triples(source):
        if rnd is None:
            continue
        if name == "round":
            per_round.setdefault(int(rnd), {})["round"] = dur_s
        elif name.startswith("round."):
            phase = name.split(".", 1)[1]
            if phase in PHASES:
                per_round.setdefault(int(rnd), {})[phase] = dur_s
    return per_round


def calibration_report(source: Iterable[Any], chunks: int = 1,
                       pipeline_rounds: bool = False,
                       a2a_wire_ratio: float = 1.0,
                       schedule: str = "serial") -> CalibrationReport:
    """Join measured round spans against ``round_time_model``.

    ``source`` — tracer spans (``Tracer.spans()``) or loaded trace
    events (``obs.load_trace(path)[0]``).  Rounds missing any of the
    four phases are skipped (counted in ``report.extra["skipped"]``).
    """
    if schedule not in ("serial", "pipelined"):
        raise ValueError(f"schedule must be serial|pipelined, "
                         f"got {schedule!r}")
    per_round = phase_durations(source)
    complete = {r: ph for r, ph in per_round.items()
                if all(p in ph for p in PHASES) and "round" in ph}
    baseline = {p: _median([ph[p] for ph in complete.values()])
                for p in PHASES}
    rows: list[CalibrationRow] = []
    for r in sorted(complete):
        ph = complete[r]
        model = round_time_model(
            ph["transfer"], ph["spatial"], ph["a2a"], ph["temporal"],
            chunks=chunks, pipeline_rounds=pipeline_rounds,
            a2a_wire_ratio=a2a_wire_ratio)
        predicted = model["serial_s"] if schedule == "serial" \
            else model["pipelined_s"]
        measured = ph["round"]
        rows.append(CalibrationRow(
            round=r,
            measured_s={p: ph[p] for p in PHASES},
            measured_round_s=measured,
            predicted_s=predicted,
            residual_s=measured - predicted,
            phase_residual_s={p: ph[p] - baseline[p] for p in PHASES}))
    return CalibrationReport(
        rows=rows, baseline_s=baseline, schedule=schedule, chunks=chunks,
        pipeline_rounds=pipeline_rounds, a2a_wire_ratio=a2a_wire_ratio,
        extra={"skipped": len(per_round) - len(complete)})
