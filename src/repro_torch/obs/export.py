"""Chrome-trace / Perfetto export for tracer spans.

The port's copy of ``repro.obs.export``: the same events for the same
spans, apart from the ``process_name`` metadata event's name
(``repro_torch``).  Under ``torchrun`` each rank writes its own file and
the events' ``pid`` differs per process, so the files open together.

Emits the Chrome Trace Event JSON format (the ``traceEvents`` array of
complete ``"ph": "X"`` events) that both ``chrome://tracing`` and
https://ui.perfetto.dev open directly.  Two file shapes:

* ``*.json``  — one object: ``{"traceEvents": [...], "displayTimeUnit":
  "ms", "repro": {metadata}}``.  Perfetto ignores the extra ``repro``
  key, which carries the metrics snapshot and export provenance.
* ``*.jsonl`` — one event per line (streaming-friendly; Perfetto accepts
  a bare JSON array, so ``load_trace`` reassembles it).

Spans nest by containment on each thread track — Perfetto stacks
duration events that lie inside each other on the same ``tid``, so the
tracer does not store parent links.  ``validate_trace`` is the schema
gate CI's trace-smoke step runs (via ``tools/check_trace.py``).
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Iterable

from repro_torch.obs.trace import Span, Tracer

__all__ = ["chrome_trace_events", "export_trace", "load_trace",
           "validate_trace"]

_REQUIRED_KEYS = ("name", "ph", "ts", "pid", "tid")


def chrome_trace_events(spans: Iterable[Span],
                        metrics: dict | None = None) -> list[dict]:
    """Spans -> Chrome trace events (µs timestamps, ``ph: "X"``)."""
    pid = os.getpid()
    events: list[dict] = []
    threads: dict[int, str] = {}
    for sp in spans:
        threads.setdefault(sp.tid, getattr(sp, "thread_name", "") or
                           f"thread-{sp.tid}")
        ev = {"name": sp.name, "cat": sp.cat or "phase", "ph": "X",
              "ts": sp.start_s * 1e6, "dur": sp.dur_s * 1e6,
              "pid": pid, "tid": sp.tid}
        if sp.attrs:
            ev["args"] = {k: v for k, v in sp.attrs.items()}
        events.append(ev)
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": "repro_torch"}}]
    for tid, tname in sorted(threads.items()):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": tname}})
    if metrics:
        for name, val in sorted(metrics.get("counters", {}).items()):
            meta.append({"name": name, "ph": "C", "pid": pid, "tid": 0,
                         "ts": 0, "args": {"value": val}})
    return meta + events


def export_trace(path: str | os.PathLike, tracer: Tracer | None = None,
                 spans: Iterable[Span] | None = None,
                 metrics: dict | None = None) -> Path:
    """Write spans as a Perfetto-loadable trace; returns the path.

    ``.jsonl`` suffix -> one event per line; anything else -> a single
    ``{"traceEvents": ...}`` object.
    """
    if spans is None:
        if tracer is None:
            from repro_torch import obs
            tracer = obs.get_tracer()
        spans = tracer.spans()
    if metrics is None:
        from repro_torch.obs.metrics import REGISTRY
        metrics = REGISTRY.snapshot()
    events = chrome_trace_events(spans, metrics=metrics)
    meta = {"format": "chrome-trace", "clock": "perf_counter",
            "exported_unix_s": time.time(),
            "dropped_spans": tracer.dropped if tracer is not None else 0,
            "metrics": metrics}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix == ".jsonl":
        with path.open("w") as fh:
            fh.write(json.dumps({"repro_meta": meta}) + "\n")
            for ev in events:
                fh.write(json.dumps(ev) + "\n")
    else:
        with path.open("w") as fh:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "repro": meta}, fh, indent=1)
    return path


def load_trace(path: str | os.PathLike) -> tuple[list[dict], dict]:
    """Read a trace written by ``export_trace`` -> (events, meta)."""
    path = Path(path)
    if path.suffix == ".jsonl":
        events, meta = [], {}
        with path.open() as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                if "repro_meta" in obj:
                    meta = obj["repro_meta"]
                else:
                    events.append(obj)
        return events, meta
    doc = json.loads(path.read_text())
    return doc.get("traceEvents", []), doc.get("repro", {})


def validate_trace(events: list[dict]) -> list[str]:
    """Schema check -> list of problems (empty = valid Chrome trace).

    Checks what Perfetto actually needs: required keys per event, the
    ``ph`` code, numeric non-negative timestamps, and ``dur`` on every
    complete event.
    """
    problems: list[str] = []
    if not events:
        return ["trace contains no events"]
    for i, ev in enumerate(events):
        missing = [k for k in _REQUIRED_KEYS
                   if k not in ev and not (k == "ts" and ev.get("ph") == "M")]
        if missing:
            problems.append(f"event {i}: missing keys {missing}")
            continue
        ph = ev["ph"]
        if ph not in ("X", "M", "C", "B", "E", "i"):
            problems.append(f"event {i}: unknown ph {ph!r}")
        if ph == "X":
            if "dur" not in ev:
                problems.append(f"event {i}: complete event missing dur")
            elif not (isinstance(ev["dur"], (int, float))
                      and ev["dur"] >= 0):
                problems.append(f"event {i}: bad dur {ev['dur']!r}")
            if not (isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0):
                problems.append(f"event {i}: bad ts {ev['ts']!r}")
        if "args" in ev and not isinstance(ev["args"], dict):
            problems.append(f"event {i}: args must be an object")
    return problems
