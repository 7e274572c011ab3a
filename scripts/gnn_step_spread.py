"""How far two identical steps of a static-GNN cell drift apart on the
card: the run-to-run spread that bounds any comparison of a re-ordered
step (a grid of ranks against one rank) with a single run.

    python3 scripts/gnn_step_spread.py [--arch gatedgcn] [--shape full_graph_sm]

Builds the cell at 1 x 1 at its full config on cuda:0 (TF32 off), takes
one train step from ``make_inputs(0)`` twice, then twice more under
``torch.use_deterministic_algorithms(True)``, and prints for the
parameters, AdamW's m and v and the loss the worst max |diff| over the
leaf's own max |value| (and the leaf) between each pair, and the card's
name and power limit.  The default atomics of ``index_add`` and of the
scatters sum in another order each run; the deterministic pair should
read 0.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _step(steps, torch, arch: str, shape: str, deterministic: bool) -> dict:
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    cell = steps.build_cell(arch, shape, None, device="cuda")
    out = steps.input_leaves(cell.step(*cell.make_inputs(0)))
    torch.cuda.synchronize()
    return {k: v.detach().double().cpu() for k, v in out.items()}


def _worst(a: dict, b: dict, prefix: str) -> tuple[float, str | None]:
    worst, leaf = 0.0, None
    for k, x in a.items():
        if not k.startswith(prefix) or not x.is_floating_point():
            continue
        top = float(b[k].abs().max())
        r = float((x - b[k]).abs().max()) / max(top, 1e-30)
        if r > worst:
            worst, leaf = r, k
    return worst, leaf


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gatedgcn")
    ap.add_argument("--shape", default="full_graph_sm")
    args = ap.parse_args()
    import torch

    from repro_torch.launch import steps

    if not torch.cuda.is_available():
        raise SystemExit("gnn_step_spread: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    runs = [_step(steps, torch, args.arch, args.shape, det)
            for det in (False, False, True, True)]
    print(f"{args.arch} x {args.shape}, one step twice ({card})")
    for name, prefix in (("params", "0."), ("m", "1.m."), ("v", "1.v."),
                         ("loss", "2")):
        free = _worst(runs[0], runs[1], prefix)
        det = _worst(runs[2], runs[3], prefix)
        print(f"  {name}: atomics {free[0]:.3e} ({free[1]}), deterministic "
              f"{det[0]:.3e} ({det[1]})")


if __name__ == "__main__":
    main()
