"""The port's benchmark: one run of one cell.

    python3 perfbench/run.py --workload cdgcn.weak_scale --seed 7 \
        --seconds 30 --trace 0

Run from the root of a checkout.  It makes the cell's inputs on the card
from ``--seed``, builds the port's train step, drives its first three
steps in set-up, measures whole steps for ``--seconds``, with ``--trace
1`` reads the per-layer metrics from a device trace after the window,
compares the first three steps with the plain reference, and prints one
JSON line last.  A cell on 4 chips starts ranks 1-3 itself (this process
is rank 0, which prints), one card each, over NCCL.

Exit codes: 0 a result printed; 2 no card (or too few), or a checkout
without the port; 3 JAX or the JAX package was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from datetime import timedelta  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names that may not be loaded (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the checkout's fixed cache directories
CACHES = {"TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions",
          "TRITON_CACHE_DIR": ".bench_cache/triton",
          "CUDA_CACHE_PATH": ".bench_cache/nv"}


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by rank 0 for the ranks it starts
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--t-start", type=float, default=None,
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(script: str, argv: list[str], chips: int, port: int,
                t_start: float) -> list:
    """Ranks 1 .. chips - 1: ``script`` with ``argv`` and its rank."""
    return [subprocess.Popen(
        [sys.executable, script, *argv, "--rank", str(r), "--port",
         str(port), "--t-start", repr(t_start)], cwd=str(ROOT))
        for r in range(1, chips)]


def join_ranks(script: str, argv: list[str], chips: int, rank: int,
               port: int, t_start: float):
    """This rank's card and, over several chips, the NCCL group of all
    ranks (rank 0 starts the others first) -> (device, group, procs)."""
    import torch
    import torch.distributed as dist

    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    if chips == 1:
        return device, None, []
    procs = []
    if rank == 0:
        port = free_port()
        procs = start_ranks(script, argv, chips, port, t_start)
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{port}", world_size=chips,
        rank=rank, timeout=timedelta(seconds=300), device_id=device)
    return device, dist.group.WORLD, procs


def stop_ranks(procs: list, grace_s: float) -> list[int]:
    """Wait for every rank started; end those still running after
    ``grace_s`` -> their exit codes."""
    end = time.time() + grace_s
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(0.0, end - time.time())))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


def result_line(cell, res: dict, trace: bool, device: dict) -> dict:
    if trace:
        metrics = {m["name"]: {"value": res["per_layer"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.per_layer
                   if res["per_layer"].get(m["name"]) is not None}
    else:
        values = {"step_s": res["step_s"], "setup_s": res["setup_s"],
                  "peak_gb": res["peak_bytes"] / 1e9}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    line = {"correct": res["correct"], "attempted": res["window_steps"],
            "failed": 0 if res["losses_ok"] else res["window_steps"],
            "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    return line


def main(argv=None) -> int:
    args = parse(argv)
    if args.t_start is None:
        args.t_start = T_START
    bench_file = ROOT / "BENCHMARK.json"
    if not (ROOT / "src" / "repro_torch").is_dir() or not bench_file.is_file():
        log("[bench] this checkout has no src/repro_torch (the port) or no "
            "BENCHMARK.json: nothing to measure")
        return 2
    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    import torch.distributed as dist

    from perfbench import harness

    bench = json.loads(bench_file.read_text())
    cell = harness.load_cell(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"[bench] {args.workload} needs {cell.chips} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    argv = ["--workload", args.workload, "--seed", str(args.seed),
            "--seconds", str(args.seconds), "--trace", str(args.trace)]
    device, group, procs = join_ranks(str(Path(__file__).resolve()), argv,
                                      cell.chips, args.rank, args.port,
                                      args.t_start)
    try:
        res = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                          args.t_start, device, group, log=log)
    finally:
        if group is not None:
            dist.destroy_process_group()
        codes = stop_ranks(procs, 60.0)
    found = forbidden_modules()
    if found:
        log(f"[bench] forbidden modules loaded: {found}")
        return 3
    if args.rank != 0:
        return 0
    if any(codes):
        log(f"[bench] a rank exited with {codes}")
        return 1
    props = torch.cuda.get_device_properties(0)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips, "memory_peak_bytes": res["peak_bytes"],
                   **res["device"]}
    line = result_line(cell, res, bool(args.trace), device_info)
    log(f"[bench] card {props.name}, {props.total_memory} B")
    for name, c in res["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
