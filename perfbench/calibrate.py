"""The readings a cell's limits are set from, at the cell's own size, in
one process a rank (not run by the benchmark's runs).

    python3 perfbench/calibrate.py --workload cdgcn.weak_scale \
        --seeds 11,12,...  --control-seeds 11,12,13 --out FILE.jsonl

For every seed: the port's first three steps (set-up as a run makes
them) against the float32 reference -> the lower readings.  For the
control seeds also: the reference in TF32 (the control) put in the port's
place, the reference with half of the batch left out, and a state left
unchanged (worked out from the reference alone: losses stay at step 1's,
the moments and the change stay 0) -> the upper readings.  One JSON line
a seed.  A cell on 4 chips starts its ranks as ``run.py`` does; rank 0
runs the references while the others wait.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def unchanged(ref: dict) -> dict:
    """What a step that returns its state unchanged would read."""
    return {"losses": [ref["losses"][0]] * len(ref["losses"]),
            "grad1": {k: v * 0 for k, v in ref["grad1"].items()},
            "delta": {k: v * 0 for k, v in ref["delta"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", required=True)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--t-start", type=float, default=0.0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    import torch.distributed as dist

    from perfbench import harness, judge, run
    from perfbench.reference import common

    if not torch.cuda.is_available():
        print("calibrate: needs the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(bench, args.workload)
    model = harness.reference_model(cell.cfg)
    argv = ["--workload", args.workload, "--seeds", args.seeds,
            "--control-seeds", args.control_seeds, "--out", args.out]
    device, group, procs = run.join_ranks(
        str(Path(__file__).resolve()), argv, cell.chips, args.rank,
        args.port, time.time())
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as fh:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats(device)
            prog, params0, readings = harness.first_steps(cell, seed, device,
                                                          group)
            peak = torch.cuda.max_memory_allocated(device)
            del prog
            harness.free(device)
            if args.rank != 0:
                dist.barrier(group=group)
                continue
            t1 = time.perf_counter()
            data = common.graphs_of(seed, cell.traffic, device)
            ref = common.train(model, cell.cfg, cell.traffic, seed, params0,
                               data=data)
            rec = {"workload": cell.name, "seed": seed, "peak_bytes": peak,
                   "program_s": t1 - t0,
                   "reference_s": time.perf_counter() - t1,
                   "losses": {"program": readings["losses"],
                              "reference": ref["losses"]},
                   "program": judge.numbers(readings, ref)}
            if seed in controls:
                torch.backends.cuda.matmul.allow_tf32 = True
                ctl = common.train(model, cell.cfg, cell.traffic, seed,
                                   params0, tf32=True, data=data)
                torch.backends.cuda.matmul.allow_tf32 = False
                half = common.train(model, cell.cfg, cell.traffic, seed,
                                    params0, fault="half_batch", data=data)
                rec.update({"control": judge.numbers(ctl, ref),
                            "half_batch": judge.numbers(half, ref),
                            "unchanged": judge.numbers(unchanged(ref), ref)})
            del data
            harness.free(device)
            rec["seconds"] = time.perf_counter() - t0
            line = json.dumps(rec)
            print(line, flush=True)
            fh.write(line + "\n")
            if group is not None:
                dist.barrier(group=group)
    if group is not None:
        dist.destroy_process_group()
    return 1 if any(run.stop_ranks(procs, 60.0)) else 0


if __name__ == "__main__":
    sys.exit(main())
