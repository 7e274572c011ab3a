"""The rank program of ``tests/test_torch_gnn_ranks.py`` and
``tests/test_torch_din_ranks.py``: the static-GNN and DIN cells over
2 x 2, 4 x 1 and 1 x 4 grids of spawned gloo ranks.  The ranks import this
module, so it imports no JAX.

A case names an arch, a registry shape, its ``shape_override``, a
``config_override`` of the smoke config (``config``) and a grid;
its inputs are whole trees of numpy arrays (one init and its AdamW state,
given to the reference's cell too, and the batch it takes), which every rank
slices by its cell's ``in_specs``.  A rank returns its shares of the
outputs and the cell's ``out_specs``, so the test puts them back together
with ``gather_tree``.  Rank 0 also runs each case's first cell over a
one-rank subgroup (a 1 x 1 grid) and with no grid, on the same inputs,
and records whether the two agree bit for bit.
"""

from __future__ import annotations

import datetime
import pickle
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import cells_ranks
from repro_torch.core.models import ParamTree
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh, steps


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.nn.Module):
        return {k: _np(p) for k, p in tree.named_parameters()}
    return tree.detach().numpy().copy()


def tree_numpy(tree):
    """A tree of dicts and lists of tensors -> the same of numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_numpy(v) for v in tree]
    return tree.detach().numpy().copy()


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v) for v in tree]
    return torch.as_tensor(np.array(tree, copy=True))


def build(case: dict, grid):
    return steps.build_cell(case["arch"], case["shape"], grid, smoke=True,
                            shape_override=case.get("override"),
                            config_override=case.get("config"),
                            device="cpu")


def run_case(case: dict, inputs: tuple, grid) -> dict:
    """This rank's shares of the case's outputs (``grid`` None: one
    rank): a train step's loss, parameters and AdamW ``m`` / ``v`` /
    ``master``; a serve step's logits; a retrieval's scores."""
    cell = build(case, grid)
    grid = grid or shd.Grid(1, 1, 0, None, None)
    specs = cell.in_specs
    args = []
    for i, (x, sp) in enumerate(zip(inputs, specs, strict=True)):
        part = shd.shard_tree(x, sp, grid) if isinstance(sp, dict) else \
            shd.shard(x, sp, grid)
        train = cell.kind not in ("recsys_serve", "retrieval")
        args.append(ParamTree(_tensors(part)) if i == 0 and train
                    else _tensors(part))
    out = cell.step(*args)
    if cell.family == "gnn" or cell.kind == "recsys_train":
        params, opt, loss = out
        return {"loss": float(loss), "params": _np(params),
                "m": _np(opt["m"]), "v": _np(opt["v"]),
                "master": _np(opt["master"]), "specs": cell.out_specs}
    return {"out": _np(out), "specs": cell.out_specs}


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, float):
        return a == b
    if isinstance(a, tuple):
        return a == b
    return a.dtype == b.dtype and np.array_equal(a, b)


def rank_main(rank: int, store_path: str, in_path: str, out_dir: str,
              world: int) -> None:
    """Every case on this rank -> ``rank<r>.pkl`` in ``out_dir``: {case
    name: run_case's output, with the seconds it took}; rank 0 adds
    ``"one_rank_equal"``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        with open(in_path, "rb") as f:
            cases = pickle.load(f)
        res = {}
        for name, (case, inputs) in cases.items():
            t0 = time.perf_counter()
            grid = mesh.make_host_mesh(*case["grid"])
            res[name] = run_case(case, inputs, grid)
            res[name]["seconds"] = time.perf_counter() - t0
        alone = dist.new_group([0])
        if rank == 0:
            name, (case, inputs) = next(iter(cases.items()))
            one = run_case(case, inputs, mesh.make_host_mesh(
                1, 1, group=alone))
            res["one_rank_equal"] = _same(
                {k: v for k, v in one.items() if k != "specs"},
                {k: v for k, v in run_case(case, inputs, None).items()
                 if k != "specs"})
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def run_ranks(nprocs: int, args: tuple, deadline_s: float) -> None:
    """``rank_main`` on ``nprocs`` spawned ranks (``tests/cells_ranks.py``'s
    launcher: a failure or the deadline kills the rest and fails)."""
    cells_ranks.run_ranks(nprocs, args + (nprocs,), deadline_s, rank_main)


def session(cases: dict, inputs: dict, tmp: Path, deadline_s: float
            ) -> tuple[dict, bool, dict]:
    """Every case on one session of 4 ranks -> (each case's gathered
    outputs, rank 0's one-rank check, each case's seconds on rank 0)."""
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({n: (cases[n], inputs[n]) for n in cases}, f)
    run_ranks(4, (str(tmp / "store"), str(tmp / "in.pkl"), str(tmp)),
              deadline_s)
    res = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    got = {n: gathered(res, n, cases[n]["grid"]) for n in cases}
    return (got, res[0]["one_rank_equal"],
            {n: res[0][n]["seconds"] for n in cases})


def gathered(results: list[dict], name: str, grid_shape: tuple) -> dict:
    """The ranks' shares of case ``name`` put back together: a train
    step's loss (every rank's), parameters and AdamW state; a serve
    step's or a retrieval's output."""
    grid = shd.Grid(*grid_shape, 0, None, None)
    first = results[0][name]
    parts = [r[name] for r in results]
    if "out" in first:
        return {"out": shd.gather_tree([{"x": p["out"]} for p in parts],
                                       {"x": first["specs"]}, grid)["x"]}
    p_sp, o_sp, _ = first["specs"]
    out = {"loss": [p["loss"] for p in parts],
           "params": shd.gather_tree([p["params"] for p in parts],
                                     shd.flat_specs(p_sp), grid)}
    for k in ("m", "v", "master"):
        out[k] = shd.gather_tree([p[k] for p in parts], o_sp[k], grid)
    return out
