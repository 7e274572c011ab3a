"""BENCHMARK.json against the contract's character and shape rules, the
result line's keys, and no JAX anywhere in a run."""

import json
import re
import subprocess
import sys

import pytest

from perfbench import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def line_ok(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert all(line_ok(w) for w in BENCH["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"])
        assert line_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"])
        assert NAME.match(w["traffic"]) and line_ok(w["why"])
        assert w["chips"] in (1, 4)
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert line_ok(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert len(names) == len(set(names))
    for f in (ROOT / "perfbench").rglob("*"):
        if "__pycache__" not in f.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$",
                            str(f.relative_to(ROOT))), f


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_and_reads(workload):
    cell = harness.load_cell(BENCH, workload)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
    assert (ROOT / "perfbench" / "limits" / f"{workload}.json").is_file()


def test_result_line_keys():
    from perfbench import run

    cell = harness.load_cell(BENCH, BENCH["workloads"][0]["name"])
    res = {"correct": True, "window_steps": 9, "losses_ok": True,
           "step_s": 1.0, "setup_s": 2.0, "peak_bytes": 3e9,
           "per_layer": {m["name"]: 1.0 for m in cell.per_layer},
           "breakdown": {"device_ops": [], "idle_gaps": []},
           "checks": {"loss": {"value": 0.0, "limit": 1.0}}}
    dev = {"platform": "gpu", "kind": "x", "count": 1,
           "memory_peak_bytes": 1}
    for trace in (False, True):
        line = run.result_line(cell, res, trace, dev)
        keys = list(line)
        assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                            "device"] and keys[-1] == "checks"
        assert ("breakdown" in line) == trace
        want = {m["name"] for m in (cell.per_layer if trace
                                    else cell.end_to_end)}
        assert set(line["metrics"]) == want
        json.dumps(line)


def test_forbidden_names_are_whole():
    from perfbench import run

    fake = ["jaxy", "repro_torch", "reproduce", "jax.numpy"]
    for m in fake:
        sys.modules.setdefault(m, type(sys)(m))
    try:
        found = run.forbidden_modules()
        assert "repro" not in found
        assert ("jax" in found) == any(m.split(".")[0] == "jax"
                                       for m in sys.modules)
    finally:
        for m in fake:
            sys.modules.pop(m, None)


def test_a_run_loads_no_jax():
    code = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "from perfbench import harness, run\n"
        "cfg = json.loads(open('perfbench/configs/tmgcn.json').read())\n"
        "t = {'nodes': 40, 'steps': 16, 'edges_per_snapshot': 100,"
        " 'generator': 'uniform', 'ranks': 1, 'lane_multiple': 128}\n"
        "harness.run(harness.Cell('x', 1, cfg, t), 3, 0.1, False,"
        " time.time(), 'cpu', log=lambda m: None)\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert json.loads(out.stdout.splitlines()[-1]) == []
