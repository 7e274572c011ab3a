"""Trace checker: schema-validate an exported ``--trace`` file and
assert the spans a healthy run must contain (the port's copy of the
reference's ``tools/check_trace.py``, over ``repro_torch.obs``).

The trace must be a valid Chrome-trace / Perfetto file
(``obs.validate_trace``), every completed round must carry all four
round-phase spans (``round.transfer`` / ``round.spatial`` /
``round.a2a`` / ``round.temporal`` — the phases ``round_time_model``
predicts), and any ``--require``'d span names (e.g. the prefetch staging
threads) must be present.  On the same file it prints what the
reference's checker prints and exits with its code.

Usage::

    python -m repro_torch.obs.check trace.json \
        --phases --require prefetch.stage --require prefetch.wait

Exits non-zero with one line per problem on stderr; otherwise prints
``<trace>: OK (N events, R rounds)`` on stdout and exits 0.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.obs import PHASES, load_trace, validate_trace


def _round_phases(events, r) -> list[str]:
    """The phase spans round ``r`` lacks."""
    have = {ev["name"] for ev in events
            if ev.get("args", {}).get("round") == r}
    return [f"round.{p}" for p in PHASES if f"round.{p}" not in have]


def check(path: str, require: list[str], phases: bool) -> list[str]:
    events, meta = load_trace(path)
    problems = [f"{path}: {p}" for p in validate_trace(events)]
    if problems:
        return problems
    names = {ev["name"] for ev in events}
    for name in require:
        if name not in names:
            problems.append(f"{path}: required span {name!r} missing "
                            f"(have {sorted(names)})")
    if phases:
        rounds = sorted({ev["args"]["round"] for ev in events
                         if ev["name"] == "round"
                         and "round" in ev.get("args", {})})
        if not rounds:
            problems.append(f"{path}: no 'round' spans — not a traced "
                            "streamed run?")
        for r in rounds:
            missing = _round_phases(events, r)
            # the last round may be cut off mid-flight (preemption /
            # stop_fn) — phases are derived after the step completes
            if missing and r != rounds[-1]:
                problems.append(f"{path}: round {r} missing phase spans "
                                f"{missing}")
        if len(rounds) >= 2 and meta.get("dropped_spans", 0) == 0:
            # with no ring overflow, every complete round must be whole —
            # including the last one when the run wasn't cut short
            missing = _round_phases(events, rounds[-1])
            if missing:
                problems.append(f"{path}: final round {rounds[-1]} missing "
                                f"phase spans {missing}")
    return problems


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.check")
    ap.add_argument("trace", help="trace file written by --trace")
    ap.add_argument("--require", action="append", default=[],
                    metavar="NAME", help="span name that must be present "
                    "(repeatable)")
    ap.add_argument("--phases", action="store_true",
                    help="assert all four round_time_model phase spans "
                    "(transfer/spatial/a2a/temporal) on every round")
    args = ap.parse_args(argv)
    problems = check(args.trace, args.require, args.phases)
    for p in problems:
        print(p, file=sys.stderr)
    if not problems:
        events, _ = load_trace(args.trace)
        rounds = {ev["args"]["round"] for ev in events
                  if ev["name"] == "round" and "round" in ev.get("args", {})}
        print(f"{args.trace}: OK ({len(events)} events, "
              f"{len(rounds)} rounds)")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
