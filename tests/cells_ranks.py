"""The rank program of ``tests/test_torch_cells.py``'s two-rank case: the
three dyngnn cells over a 2 x 1 grid of spawned gloo ranks.  The ranks
import this module, so it imports no JAX."""

from __future__ import annotations

import datetime
import pickle
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.launch import mesh, steps

MODELS = ("tmgcn", "cdgcn", "evolvegcn")


def rank_main(rank: int, store_path: str, out_dir: str, world: int,
              override: dict) -> None:
    """One step of each model's cell from ``make_inputs(0)`` (this rank's
    share) -> rank 0 pickles each loss, the updated parameters and AdamW's
    state (``m`` holds (1 - b1) x the clipped, all-reduced gradient)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        grid = mesh.make_host_mesh(world, 1)
        res = {}
        for model in MODELS:
            cell = steps.build_cell(model, "dtdg_epinions", grid,
                                    shape_override=override, device="cpu")
            params, opt, loss = cell.step(*cell.make_inputs(0))
            res[model] = {"loss": float(loss), "state": {
                k: t.detach().numpy().copy()
                for k, t in steps.input_leaves((params, opt)).items()}}
        if rank == 0:
            with open(Path(out_dir) / "ranks.pkl", "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def run_ranks(nprocs: int, args: tuple, deadline_s: float,
              fn=rank_main) -> None:
    """``fn`` (default ``rank_main``) on ``nprocs`` spawned ranks, joined
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
