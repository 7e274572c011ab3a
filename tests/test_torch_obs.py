"""The port's trace export and round-time calibration (``repro_torch.obs``)
held to the JAX package's (``repro.obs``).

* On the same hand-made spans, ``chrome_trace_events`` gives the
  reference's events but for the ``process_name`` metadata event's name;
  ``export_trace`` writes ``.json`` and ``.jsonl`` files that both
  packages' ``load_trace`` read back as those events; ``validate_trace``
  finds the reference's problems in the reference's malformed events
  (``tests/test_obs.py``), in the same words.
* ``calibration_report`` gives the reference's rows, baseline medians and
  ``summary()`` (rel 1e-12) for every schedule knob, on spans and on
  loaded events.
* The tracer's ``phases`` switch, ``add_span``, ``clear`` and iteration.
* A traced ``streamed_mesh`` fit (TM-GCN, N = 48, T = 16, nb 2, 2 epochs)
  on 4 gloo ranks, beside an untraced one: every round of every rank has
  the ``round`` span and all four phases (the derived three sum to
  ``round.step``), rank 0 alone times ``round.probe``; the losses and
  parameters equal the untraced fit's bit for bit; the probe's three
  steps on rank 0 add exactly three one-rank rounds of 8 snapshots to
  the launch, CSR-build and all-to-all counts and three
  ``stream.csr_pair`` spans to the trace, and nothing to
  ``stream.rounds`` (``stream/distributed.py``'s rule), and the other
  ranks' counts do not move; the round spans' names, categories and
  attributes equal a JAX traced fit's on 4 host devices
  (``tests/test_obs.py``); each rank's exported file passes the
  reference's ``tools/check_trace.py --phases --require prefetch.stage
  --require prefetch.wait``.
* The port's trace checker (``python -m repro_torch.obs.check``) gives
  the reference checker's exit code, stdout and stderr on the same files:
  the pool's rank 0 and rank 1 traces, a round missing ``round.a2a``, a
  final round missing a phase (with and without spans lost to the ring),
  one cut-short round, a missing ``--require``d span, a malformed event,
  a trace with no rounds under ``--phases``, and a ``.jsonl`` file.

The ranks are spawned and import this module for their program, so it
imports no JAX at its top: the reference is the ``ref`` fixture's.
"""

import datetime
import json
import os
import pickle
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import convert, obs
from repro_torch.core import models as tm
from repro_torch.kernels.mproduct import ops as mp_ops
from repro_torch.kernels.segment_spmm import ops as spmm_ops
from repro_torch.obs.trace import Tracer
from repro_torch.run import Engine, ExecutionPlan, RunConfig, SyntheticTrace

ROOT = Path(__file__).resolve().parents[1]
P = 4
N, T, NB, W = 48, 16, 2, 3
WIN = T // NB
EPOCHS = 2
ROUNDS = EPOCHS * NB
LAYERS = 2
POOL_DEADLINE_S = 150
# what one step of a one-rank TM-GCN round of WIN snapshots adds to the
# counts: 2 forward and 1 backward aggregate a snapshot, one band and its
# backward a layer, a CSR pair a snapshot, 2 all-to-alls a layer forward
# and 2 backward
ONE_RANK_ROUND = {"spmm": 3 * WIN, "ttm": LAYERS, "ttm_t": LAYERS,
                  "csr_builds": 2 * WIN, "partition.a2a_calls": 4 * LAYERS}
PROBE_STEPS = 3          # one warm run, then the best of 2


# ------------------------------------------------------- the rank program ---

def _silent(_msg):
    return None


def _fit(traced: bool, out_dir: str, rank: int) -> dict:
    """One ``streamed_mesh`` Engine fit on the world group, traced or
    not, with its counts: the kernels' plain versions (reached through
    the same wrappers as on the card), the CSR builds and the obs
    counters of the fit."""
    calls = {"spmm": 0, "ttm": 0, "ttm_t": 0}
    patched = [(spmm_ops, "segment_spmm_csr_ref", "spmm"),
               (mp_ops, "banded_ttm_ref", "ttm"),
               (mp_ops, "banded_ttm_t_ref", "ttm_t")]
    saved = [getattr(mod, name) for mod, name, _ in patched]

    def counted(key, fn):
        def call(*a):
            calls[key] += 1
            return fn(*a)
        return call

    for (mod, name, key), fn in zip(patched, saved, strict=True):
        setattr(mod, name, counted(key, fn))
    spmm_ops.csr_builds = 0
    tracer = obs.configure(enabled=traced)
    try:
        res = Engine(RunConfig(
            model=tm.DynGNNConfig(model="tmgcn", num_nodes=N, num_steps=T,
                                  window=W, checkpoint_blocks=NB),
            data=SyntheticTrace(num_nodes=N, num_steps=T, density=2.0,
                                churn=0.1, smoothing_mode="mproduct",
                                window=W),
            plan=ExecutionPlan(mode="streamed_mesh", shards=P,
                               num_epochs=EPOCHS), log_fn=_silent),
            device="cpu").fit()
        spans = [(s.name, s.cat, dict(s.attrs), s.start_s, s.dur_s)
                 for s in tracer.spans()]
        path = None
        if traced:
            path = Path(out_dir) / f"trace.rank{rank}.json"
            obs.export_trace(path)
    finally:
        obs.configure(enabled=False)
        for (mod, name, _), fn in zip(patched, saved, strict=True):
            setattr(mod, name, fn)
    return {"losses": res.losses,
            "params": convert.params_to_numpy(res.state.params),
            "counts": dict(calls, csr_builds=spmm_ops.csr_builds,
                           **res.metrics["counters"]),
            "spans": spans, "trace": str(path) if path else None}


def _rank_main(rank, store_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, P),
                            rank=rank, world_size=P,
                            timeout=datetime.timedelta(seconds=60))
    try:
        res = {"untraced": _fit(False, out_dir, rank),
               "traced": _fit(True, out_dir, rank)}
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, nprocs: int, args: tuple, deadline_s: float) -> None:
    """Start ``nprocs`` spawned ranks of ``fn(rank, *args)`` and join them
    by ``deadline_s``; a rank's failure, or the deadline, kills the rest
    and fails."""
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=max(end - time.monotonic(), 0.0)):
            if time.monotonic() >= end:
                raise TimeoutError(f"{nprocs} ranks still running after "
                                   f"{deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


# ------------------------------------------------------------ fixtures ------

@pytest.fixture(scope="module")
def ref():
    """The JAX package's ``obs`` and Engine, here in the parent only."""
    from repro import obs as jobs
    from repro.core.models import DynGNNConfig
    from repro.obs.trace import Tracer as JTracer
    from repro.run import Engine as JEngine
    from repro.run import ExecutionPlan as JPlan
    from repro.run import RunConfig as JRunConfig
    from repro.run import SyntheticTrace as JTrace
    return types.SimpleNamespace(**locals())


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """The untraced and the traced fit on 4 gloo ranks -> [rank 0's
    results, ..., rank 3's]."""
    d = tmp_path_factory.mktemp("obs")
    run_ranks(_rank_main, P, (str(d / "store"), str(d)), POOL_DEADLINE_S)
    out = []
    for r in range(P):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def jax_round_spans(ref):
    """The round spans of ``tests/test_obs.py``'s traced fit: the JAX
    Engine, ``streamed_mesh`` on 4 host devices, the same trace."""
    prev = ref.jobs.get_tracer()
    ref.jobs.configure(enabled=True)
    try:
        ref.JEngine(ref.JRunConfig(
            model=ref.DynGNNConfig(model="tmgcn", num_nodes=N, num_steps=T,
                                   window=W, checkpoint_blocks=NB),
            data=ref.JTrace(num_nodes=N, num_steps=T, density=2.0,
                            churn=0.1, smoothing_mode="mproduct", window=W),
            plan=ref.JPlan(mode="streamed_mesh", shards=P,
                           num_epochs=EPOCHS), log_fn=_silent)).fit()
        spans = ref.jobs.get_tracer().spans()
    finally:
        ref.jobs.set_tracer(prev)
    return [(s.name, s.cat, dict(s.attrs)) for s in spans]


# ------------------------------------------------- hand-made spans ----------

def _synthetic(tracers, rounds=4, straggle=2):
    """The same spans into every tracer: rounds of the four phases (round
    ``straggle`` lost time in its a2a), a derived span, an incomplete
    round and a span on another thread id."""
    for trc in tracers:
        for r in range(rounds):
            a2a = 0.020 if r == straggle else 0.008
            phases = (("transfer", 0.010), ("spatial", 0.020), ("a2a", a2a),
                      ("temporal", 0.030))
            t0 = float(r)
            trc.add_span("round", t0, sum(d for _, d in phases) + 0.001,
                         cat="round", round=r, p=4, win=8)
            off = 0.0
            for name, dur in phases:
                trc.add_span(f"round.{name}", t0 + off, dur,
                             cat="phase.derived", round=r, derived=True)
                off += dur
        trc.add_span("round", 9.0, 0.1, cat="round", round=9)
        trc.add_span("prefetch.stage", 0.5, 0.002, cat="prefetch", tid=7)
        trc.add_span("round.probe", 1.5, 0.05, cat="probe")


def _without_process_name(events):
    return [e for e in events if e["name"] != "process_name"]


def test_chrome_trace_events_are_the_reference_s(ref):
    mine, theirs = Tracer(enabled=True), ref.JTracer(enabled=True)
    _synthetic([mine, theirs])
    metrics = {"counters": {"stream.rounds": 4, "partition.a2a_calls": 32},
               "gauges": {}}
    got = obs.chrome_trace_events(mine.spans(), metrics=metrics)
    want = ref.jobs.chrome_trace_events(theirs.spans(), metrics=metrics)
    assert _without_process_name(got) == _without_process_name(want)
    names = [e for e in got if e["name"] == "process_name"]
    assert names == [{"name": "process_name", "ph": "M", "pid": os.getpid(),
                      "tid": 0, "args": {"name": "repro_torch"}}]
    assert len(got) == len(want)
    threads = {e["tid"] for e in got if e["name"] == "thread_name"}
    assert threads == {7, threading.get_ident()}


@pytest.mark.parametrize("suffix", [".json", ".jsonl"])
def test_export_and_load_give_the_reference_s_events(ref, tmp_path, suffix):
    mine, theirs = Tracer(enabled=True), ref.JTracer(enabled=True)
    _synthetic([mine, theirs])
    metrics = {"counters": {"stream.rounds": 4}, "gauges": {}}
    a = obs.export_trace(tmp_path / f"port{suffix}", tracer=mine,
                         metrics=metrics)
    b = ref.jobs.export_trace(tmp_path / f"ref{suffix}", tracer=theirs,
                              metrics=metrics)
    for path in (a, b):
        for load in (obs.load_trace, ref.jobs.load_trace):
            events, meta = load(path)
            assert obs.validate_trace(events) == []
            assert ref.jobs.validate_trace(events) == []
            assert meta["format"] == "chrome-trace"
            assert meta["dropped_spans"] == 0
            assert meta["metrics"] == metrics
    got, got_meta = obs.load_trace(a)
    want, want_meta = ref.jobs.load_trace(b)
    assert _without_process_name(got) == _without_process_name(want)
    assert sorted(got_meta) == sorted(want_meta)
    # the default metrics are the port's registry snapshot
    c = obs.export_trace(tmp_path / f"default{suffix}", tracer=mine)
    assert obs.load_trace(c)[1]["metrics"] == obs.metrics_snapshot()


def test_validate_trace_catches_the_reference_s_malformed_events(ref,
                                                                 tmp_path):
    assert obs.validate_trace([]) == ["trace contains no events"]
    bad = [
        {"ph": "X", "ts": 0, "pid": 1, "tid": 1, "dur": 1},   # no name
        {"name": "a", "ph": "Z", "ts": 0, "pid": 1, "tid": 1},
        {"name": "b", "ph": "X", "ts": -5, "pid": 1, "tid": 1, "dur": 1},
        {"name": "c", "ph": "X", "ts": 0, "pid": 1, "tid": 1},  # no dur
        {"name": "d", "ph": "X", "ts": 0, "pid": 1, "tid": 1, "dur": 1,
         "args": "nope"},
        {"name": "e", "ph": "X", "ts": 0, "pid": 1, "tid": 1, "dur": -1},
        {"name": "f", "ph": "M", "pid": 1, "tid": 1},            # no ts: ok
    ]
    problems = obs.validate_trace(bad)
    assert problems == ref.jobs.validate_trace(bad)
    assert len(problems) == 6
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": bad}))
    events, _ = obs.load_trace(p)
    assert obs.validate_trace(events) == problems


# --------------------------------------------------------- calibration ------

def _same_report(got, want):
    assert len(got.rows) == len(want.rows)
    assert got.extra == want.extra
    assert (got.schedule, got.chunks, got.pipeline_rounds,
            got.a2a_wire_ratio) == (want.schedule, want.chunks,
                                    want.pipeline_rounds, want.a2a_wire_ratio)
    for k, v in want.baseline_s.items():
        assert got.baseline_s[k] == pytest.approx(v, rel=1e-12, abs=0)
    for a, b in zip(got.rows, want.rows, strict=True):
        assert a.round == b.round
        for x, y in ((a.measured_s, b.measured_s),
                     (a.phase_residual_s, b.phase_residual_s)):
            assert sorted(x) == sorted(y)
            for k in y:
                assert x[k] == pytest.approx(y[k], rel=1e-12, abs=1e-15)
        for name in ("measured_round_s", "predicted_s", "residual_s",
                     "rel_residual"):
            assert getattr(a, name) == pytest.approx(getattr(b, name),
                                                     rel=1e-12, abs=1e-15)
    assert got.summary() == want.summary()


@pytest.mark.parametrize("knobs", [
    {}, {"chunks": 2}, {"pipeline_rounds": True, "schedule": "pipelined"},
    {"chunks": 4, "pipeline_rounds": True, "a2a_wire_ratio": 0.25}])
def test_calibration_report_is_the_reference_s(ref, tmp_path, knobs):
    mine, theirs = Tracer(enabled=True), ref.JTracer(enabled=True)
    _synthetic([mine, theirs])
    got = obs.calibration_report(mine.spans(), **knobs)
    want = ref.jobs.calibration_report(theirs.spans(), **knobs)
    _same_report(got, want)
    assert len(got.rows) == 4 and got.extra["skipped"] == 1
    straggler = next(r for r in got.rows if r.round == 2)
    assert straggler.phase_residual_s["a2a"] == pytest.approx(0.012)
    assert obs.phase_durations(mine) == ref.jobs.phase_durations(
        theirs.spans())
    # the same report from the exported file's events
    path = obs.export_trace(tmp_path / "t.json", tracer=mine, metrics={})
    events, _ = obs.load_trace(path)
    _same_report(obs.calibration_report(events, **knobs), want)
    with pytest.raises(ValueError, match="serial|pipelined"):
        obs.calibration_report(events, schedule="both")


# -------------------------------------------------------------- tracer ------

def test_tracer_phases_add_span_clear_and_iteration():
    assert obs.configure(enabled=True, fence=False).phases
    try:
        trc = obs.configure(enabled=True, fence=False, phases=False)
        assert obs.get_tracer() is trc and obs.enabled()
        assert not trc.phases
        with obs.span("round", round=0):
            pass
        obs.add_span("round.a2a", 1.0, 0.5, round=0)
        spans = list(trc)
        assert [s.name for s in spans] == ["round", "round.a2a"]
        assert (spans[1].start_s, spans[1].dur_s, spans[1].cat) == \
            (1.0, 0.5, "derived")
        assert obs.span_summary()["round.a2a"]["count"] == 1
        trc.clear()
        assert list(trc) == [] and trc.recorded == 0 and trc.dropped == 0
        other = Tracer(enabled=False)
        assert obs.set_tracer(other) is other and not obs.enabled()
        obs.add_span("x", 0.0, 1.0)           # disabled: nothing recorded
        assert other.recorded == 0
    finally:
        obs.configure(enabled=False)


# --------------------------------------------------- traced fit, 4 ranks ----

def _round_spans(spans):
    return [s for s in spans if s[0] == "round" or s[0].startswith("round.")]


def test_traced_fit_has_every_phase_in_every_round(pool):
    for rank, res in enumerate(pool):
        spans = res["traced"]["spans"]
        events = [{"name": n, "ph": "X", "dur": d * 1e6, "args": a}
                  for n, _, a, _, d in spans]
        per_round = obs.phase_durations(events)
        assert sorted(per_round) == list(range(ROUNDS))
        for r, ph in per_round.items():
            assert set(ph) == {"round", *obs.PHASES}, (rank, r)
            step = next(d for n, _, a, _, d in spans
                        if n == "round.step" and a["round"] == r)
            derived = [d for n, c, a, _, d in spans
                       if c == "phase.derived" and a["round"] == r]
            assert len(derived) == 3
            assert sum(derived) == pytest.approx(step, rel=1e-9, abs=1e-12)
        probes = [s for s in spans if s[0] == "round.probe"]
        assert len(probes) == (2 if rank == 0 else 0)
        # a CSR-pair span a step: the rounds', and on rank 0 the probe's
        pairs = sum(s[0] == "stream.csr_pair" for s in spans)
        assert pairs == ROUNDS + (PROBE_STEPS if rank == 0 else 0)
        assert all(c == "probe" and a == {} for _, c, a, _, _ in probes)
        assert res["untraced"]["spans"] == []
        rep = obs.calibration_report(events)
        assert len(rep.rows) == ROUNDS and rep.extra["skipped"] == 0


def test_traced_fit_is_bit_identical_to_the_untraced_one(pool):
    for res in pool:
        assert res["traced"]["losses"] == res["untraced"]["losses"]
        assert len(res["traced"]["losses"]) == ROUNDS
        for k, v in res["untraced"]["params"].items():
            np.testing.assert_array_equal(res["traced"]["params"][k], v,
                                          err_msg=k)
    for res in pool[1:]:
        assert res["traced"]["losses"] == pool[0]["traced"]["losses"]


def test_the_probe_adds_three_one_rank_rounds_on_rank_0_alone(pool):
    for rank, res in enumerate(pool):
        got, base = res["traced"]["counts"], res["untraced"]["counts"]
        for key in ("stream.rounds", "stream.payload_bytes",
                    "prefetch.items"):
            assert got[key] == base[key], key
        assert base["stream.rounds"] == ROUNDS
        for key, per_round in ONE_RANK_ROUND.items():
            surplus = PROBE_STEPS * per_round if rank == 0 else 0
            assert got[key] - base[key] == surplus, (rank, key)
        # one rank's own rounds: 3 aggregates a snapshot of its 2
        assert base["spmm"] == ROUNDS * 3 * (WIN // P)
        assert base["csr_builds"] == ROUNDS * 2 * (WIN // P)


def test_round_spans_match_a_jax_traced_fit(pool, jax_round_spans):
    """Names, categories and attributes of every round span, in order of
    recording, times aside: the port's rank 0 and the JAX single
    controller record the same ones."""
    got = [(n, c, a) for n, c, a, _, _ in _round_spans(
        pool[0]["traced"]["spans"])]
    want = _round_spans([(n, c, a, 0.0, 0.0) for n, c, a in
                         jax_round_spans])
    assert got == [(n, c, a) for n, c, a, _, _ in want]
    assert len(got) == 6 * ROUNDS + 2       # 6 a round, 2 probe runs
    names = {s[0] for s in pool[0]["traced"]["spans"]}
    assert {"prefetch.stage", "prefetch.wait"} <= names
    assert {"prefetch.stage", "prefetch.wait"} <= {s[0] for s in
                                                   jax_round_spans}


def test_exported_traces_pass_the_reference_checker(pool):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    paths = [res["traced"]["trace"] for res in pool]
    for path in paths:
        events, meta = obs.load_trace(path)
        assert obs.validate_trace(events) == []
        assert meta["dropped_spans"] == 0
    for path in paths[:2]:           # rank 0 (probes) and a rank without
        out = subprocess.run(
            [sys.executable, str(ROOT / "tools" / "check_trace.py"), path,
             "--phases", "--require", "prefetch.stage", "--require",
             "prefetch.wait"], capture_output=True, text=True, timeout=120,
            env=env, cwd=ROOT)
        assert out.returncode == 0, out.stdout + out.stderr
        assert f"OK ({len(obs.load_trace(path)[0])} events, {ROUNDS} " \
            "rounds)" in out.stdout
    pids = {obs.load_trace(p)[0][0]["pid"] for p in paths}
    assert len(pids) == P


# ------------------------------------------ the trace checker's port ------

def _reference_checker():
    """``tools/check_trace.py`` as a module (it imports ``repro.obs``)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "check_trace", ROOT / "tools" / "check_trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_check(capsys, monkeypatch, args: list[str]):
    """The reference checker's (exit code, stdout, stderr) on ``args``."""
    monkeypatch.setattr(sys, "argv", ["check_trace.py", *args])
    capsys.readouterr()
    rc = _reference_checker().main()
    out = capsys.readouterr()
    return rc, out.out, out.err


def _checked_trace(path: Path, rounds: int = 3, drop=(), dropped: int = 0,
                   phases: bool = True, bad: bool = False) -> str:
    """A traced run's file: ``rounds`` rounds of the four phases and a
    prefetch span; ``drop`` ((round, phase), ...) taken out, ``dropped``
    spans said lost to the ring, ``bad`` adds a malformed event."""
    trc = Tracer(enabled=True)
    for r in range(rounds if phases else 0):
        trc.add_span("round", float(r), 0.07, cat="round", round=r)
        for k, name in enumerate(("transfer", "spatial", "a2a", "temporal")):
            if (r, name) not in drop:
                trc.add_span(f"round.{name}", r + 0.01 * k, 0.01, round=r)
    trc.add_span("prefetch.stage", 0.5, 0.002, cat="prefetch", tid=7)
    if not phases:
        trc.add_span("serve.advance", 0.1, 0.01, cat="serve")
    obs.export_trace(path, tracer=trc, metrics={"counters": {}, "gauges": {}})
    if path.suffix == ".json":
        doc = json.loads(path.read_text())
        doc["repro"]["dropped_spans"] = dropped
        if bad:
            doc["traceEvents"].append({"name": "x", "ph": "X", "ts": -1,
                                       "pid": 1, "tid": 1})
        path.write_text(json.dumps(doc))
    return str(path)


CHECKER_CASES = {
    "whole": ({}, ["--phases", "--require", "prefetch.stage"]),
    "whole_jsonl": ({"suffix": ".jsonl"}, ["--phases"]),
    "round_missing_a2a": ({"drop": ((1, "a2a"),)}, ["--phases"]),
    "final_round_missing_a_phase": ({"drop": ((2, "temporal"),)},
                                    ["--phases"]),
    "final_round_cut_short": ({"drop": ((2, "temporal"),), "dropped": 5},
                              ["--phases"]),
    "one_round_cut_short": ({"rounds": 1, "drop": ((0, "a2a"),)},
                            ["--phases"]),
    "missing_required_span": ({}, ["--require", "prefetch.stage",
                                   "--require", "prefetch.wait"]),
    "malformed_event": ({"bad": True}, ["--phases"]),
    "no_rounds": ({"phases": False}, ["--phases"]),
    "no_rounds_without_phases": ({"phases": False}, []),
}


@pytest.mark.parametrize("case", sorted(CHECKER_CASES))
def test_port_checker_prints_the_reference_s_lines(case, tmp_path, capsys,
                                                   monkeypatch):
    from repro_torch.obs import check

    kw, flags = CHECKER_CASES[case]
    kw = dict(kw)
    path = _checked_trace(tmp_path / f"t{kw.pop('suffix', '.json')}", **kw)
    want = _reference_check(capsys, monkeypatch, [path, *flags])
    capsys.readouterr()
    rc = check.main([path, *flags])
    out = capsys.readouterr()
    assert (rc, out.out, out.err) == want
    expect_ok = case.startswith(("whole", "final_round_cut", "one_round",
                                 "no_rounds_without"))
    assert rc == (0 if expect_ok else 1), out
    assert (out.out.endswith("rounds)\n") and not out.err) == expect_ok


def test_port_checker_cli_on_the_pool_s_traces(pool, capsys, monkeypatch):
    """``python -m repro_torch.obs.check`` on rank 0's and rank 1's
    exported files: the reference checker's exit code and lines."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    flags = ["--phases", "--require", "prefetch.stage", "--require",
             "prefetch.wait"]
    for res in pool[:2]:
        path = res["traced"]["trace"]
        want = _reference_check(capsys, monkeypatch, [path, *flags])
        got = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.check", path, *flags],
            capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
        assert (got.returncode, got.stdout, got.stderr) == want
        assert want[0] == 0 and f"OK ({len(obs.load_trace(path)[0])} " \
            f"events, {ROUNDS} rounds)" in got.stdout
