"""One rank of one run: set-up, the measured window, the device trace, the
per-layer readers and the comparison with the reference.

``run`` is what ``run.py`` calls on every rank; a test calls it with a CPU
device (the port's plain path) and, over ranks, a gloo group.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch
import torch.distributed as dist

from perfbench import gen, judge, profiling
from perfbench.reference import common as ref_common
from perfbench.sut import Program

ROOT = Path(__file__).resolve().parent.parent
#: the first steps, which set-up drives and the reference follows
CHECKED_STEPS = 3
#: steps the device-only trace records, and the host-recorded one
TRACE_STEPS = 2


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def load_cell(bench: dict, workload: str, root: Path = ROOT) -> Cell:
    """The workload's entry of ``BENCHMARK.json`` with its configuration
    and traffic files, and the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "perfbench" / "traffic" / f"{w['traffic']}.json")
        .read_text())
    if traffic["ranks"] != w["chips"]:
        raise ValueError(f"{workload}: traffic ranks {traffic['ranks']} "
                         f"!= chips {w['chips']}")
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])
                 and m["moves"] in names]
    return Cell(workload, w["chips"], cfg, traffic, e2e, per_layer)


def reference_model(cfg: dict):
    return importlib.import_module(f"perfbench.reference.{cfg['model']}")


def kernel_patterns(kernel: str, root: Path = ROOT) -> list[str]:
    """Name fragments of a kernel's device functions: every line of every
    ``kernel_names/<kernel>/*.txt``."""
    out = []
    for f in sorted((root / "perfbench" / "kernel_names" / kernel)
                    .glob("*.txt")):
        out += [ln.strip() for ln in f.read_text().splitlines()
                if ln.strip() and not ln.startswith("#")]
    return out


def kernel_seconds(device_ops: list, kernel: str) -> float:
    pats = kernel_patterns(kernel)
    return sum(e - s for name, s, e in device_ops
               if any(p in name for p in pats)) * 1e-6


def read_metric(name: str, ctx: dict, root: Path = ROOT):
    """``metrics/<name>.py``'s ``read(ctx)`` -> a number or None."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _any_rank(flag: bool, group, device) -> bool:
    """Whether ``flag`` holds on any rank (every rank gets the answer:
    the ranks stop the window, or trace again, together)."""
    if group is None:
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def first_steps(cell: Cell, seed: int, device, group=None, log=print):
    """Set-up's program: the port's step on the cell's inputs from ``seed``,
    its CSR pairs built and its first ``CHECKED_STEPS`` steps taken ->
    (program, initial parameters, {"losses", "grad1", "delta"})."""
    t0 = time.perf_counter()
    model = reference_model(cell.cfg)
    params0 = gen.make_params(seed, model.param_shapes(cell.cfg), device)
    prog = Program(cell.cfg, cell.traffic, seed, params0, device, group)
    _sync(device)
    t1 = time.perf_counter()
    prog.build_csrs()
    _sync(device)
    t2 = time.perf_counter()
    losses = []
    for k in range(CHECKED_STEPS):
        losses.append(prog.step())
        if k == 0:
            grad1 = prog.first_gradient()
            t3 = time.perf_counter()
    log(f"[bench] set-up: inputs {t1 - t0:.3f} s, CSR pairs {t2 - t1:.3f} "
        f"s, first step {t3 - t2:.3f} s, two more "
        f"{time.perf_counter() - t3:.3f} s")
    readings = {"losses": losses, "grad1": grad1,
                "delta": {k: v - params0[k]
                          for k, v in prog.parameters().items()}}
    return prog, params0, readings


def free(device) -> None:
    """Return what the program held to the card."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device, group=None, log=print) -> dict:
    """One rank's run -> {"setup_s", "step_s", "window_steps",
    "losses_ok", "peak_bytes", "per_layer", "device", "breakdown",
    "checks", "correct"} (the comparison's fields on rank 0 only)."""
    from repro_torch import obs

    rank = 0 if group is None else dist.get_rank(group)
    on_card = torch.device(device).type == "cuda"
    cfg, traffic = cell.cfg, cell.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = reference_model(cfg)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    tracer = obs.configure(enabled=trace)
    log(f"[bench] set-up: process start to here {time.time() - t_start:.3f}"
        " s")
    prog, params0, readings = first_steps(cell, seed, device, group, log)
    _sync(device)
    setup_s = time.time() - t_start
    spans = {k: v["total_s"] for k, v in tracer.summary().items()}
    obs.configure(enabled=False)

    before = obs.metrics_snapshot()
    window_losses = []
    _sync(device)
    t0 = time.perf_counter()
    while True:
        window_losses.append(prog.step())
        if _any_rank(time.perf_counter() - t0 >= seconds, group, device):
            break
    _sync(device)
    elapsed = time.perf_counter() - t0
    steps = len(window_losses)
    step_s = elapsed / steps
    counters = obs.metrics().delta(before)["counters"]
    log(f"[bench] rank {rank}: set-up {setup_s:.3f} s, {steps} steps in "
        f"{elapsed:.3f} s ({step_s:.4f} s a step)")

    out = {"setup_s": setup_s, "step_s": step_s, "window_steps": steps,
           "losses_ok": all(math.isfinite(x) for x in window_losses),
           "device": {}}
    if trace:
        out.update(_trace(cell, prog, step_s, steps, spans, counters,
                          on_card, group, device, log))
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if group is not None:
        t = torch.tensor([float(peak)], device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        peak = int(t.item())
    out["peak_bytes"] = peak

    # the program's state goes before the reference runs
    del prog
    free(device)
    if rank == 0:
        t0 = time.perf_counter()
        ref = ref_common.train(model, cfg, traffic, seed, params0,
                               steps=CHECKED_STEPS)
        nums = judge.numbers(readings, ref)
        ok, checks = judge.verdict(nums, judge.load_limits(ROOT,
                                                           cell.name))
        out["checks"] = checks
        out["correct"] = ok and out["losses_ok"]
        log(f"[bench] reference {time.perf_counter() - t0:.3f} s; "
            f"losses port {readings['losses']} reference {ref['losses']}")
        out["readings"] = nums
    if group is not None:
        dist.barrier(group=group)
    return out


def _trace(cell: Cell, prog: Program, step_s: float, steps: int,
           spans: dict, counters: dict, on_card: bool, group, device,
           log) -> dict:
    """The traced part of a ``--trace 1`` run: a device-only profile of
    ``TRACE_STEPS`` steps for the metrics and a host-recorded one for the
    idle gaps' names, then every per-layer reader."""
    if not on_card:
        raise RuntimeError("the device trace needs the card")
    t0 = time.perf_counter()

    def any_rank(empty):
        return _any_rank(empty, group, device)

    dev = profiling.record(prog.step, TRACE_STEPS, host=False,
                           any_rank=any_rank)
    busy_s = profiling.busy_us(dev["device"]) * 1e-6
    window_s = dev["wall_s"]
    hosted = profiling.record(prog.step, 1, host=True, any_rank=any_rank)
    log(f"[bench] trace: busy {busy_s:.4f} of {window_s:.4f} s over "
        f"{TRACE_STEPS} steps, {len(dev['device'])} device ops; read in "
        f"{time.perf_counter() - t0:.1f} s")
    ctx = {"cfg": cell.cfg, "traffic": cell.traffic, "chips": cell.chips,
           "step_s": step_s, "window_steps": steps, "profile": dev,
           "spans": spans, "counters": counters,
           "kernel_seconds": lambda k: kernel_seconds(dev["device"], k)}
    values = {m["name"]: read_metric(m["name"], ctx)
              for m in cell.per_layer}
    busy_window = [busy_s, window_s]
    if group is not None:
        t = torch.tensor(busy_window, device=device)
        dist.all_reduce(t, group=group)
        busy_window = (t / dist.get_world_size(group)).tolist()
    return {"per_layer": values,
            "device": {"busy_s": busy_window[0],
                       "window_s": busy_window[1]},
            "breakdown": {
                "device_ops": profiling.top_ops(dev["device"]),
                "idle_gaps": profiling.idle_gaps(hosted["device"],
                                                 hosted["host"])}}
