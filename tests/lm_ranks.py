"""The rank program of ``tests/test_torch_lm_ranks.py``: the LM cells over
2 x 2 and 1 x 4 grids of spawned gloo ranks.  The ranks import this
module, so it imports no JAX.

Each case names an arch, a grid, a ``config_override`` and the shapes of
its cells; its inputs are whole trees of numpy arrays (the reference's own
init, converted), which every rank slices by its cell's ``in_specs``.  A
rank returns its shards of every output and rank 0 the cells' specs, so
the test puts the outputs back together with ``gather_tree``.
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

#: decode steps a case takes from its cache
DECODE_STEPS = 3


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.nn.Module):
        return {k: _np(p) for k, p in tree.named_parameters()}
    return tree.detach().numpy().copy()


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree, copy=True))


def _build(case: dict, kind: str, grid):
    shape = {"train": "train_4k", "prefill": "prefill_32k",
             "decode": case.get("decode_shape", "decode_32k")}[kind]
    return steps.build_cell(case["arch"], shape, grid, smoke=True,
                            shape_override=case["shapes"][kind],
                            config_override=case.get("override"),
                            device="cpu")


def run_case(case: dict, inputs: dict, grid) -> dict:
    """This rank's shares of the case's outputs: one train step, a
    prefill, ``DECODE_STEPS`` decode steps (each cell the case names);
    ``grid`` None runs them on one rank."""
    cells = grid
    grid = grid or shd.Grid(1, 1, 0, None, None)
    out: dict = {"specs": {}}
    if "train" in inputs:
        cell = _build(case, "train", cells)
        p_sp, o_sp, b_sp, _ = cell.in_specs
        params, opt, tokens, targets = inputs["train"]
        p = ParamTree(_tensors(shd.shard_tree(params, p_sp, grid)))
        o = _tensors(shd.shard_tree(opt, o_sp, grid))
        o["step"] = torch.as_tensor(opt["step"], dtype=torch.int32)
        tok = [torch.as_tensor(shd.shard(a, b_sp, grid)) for a in
               (tokens, targets)]
        p, o, loss = cell.step(p, o, *tok)
        out["train"] = {"loss": float(loss), "params": _np(p),
                        "m": _np(o["m"]), "v": _np(o["v"]),
                        "master": _np(o["master"])}
        out["specs"]["train"] = (p_sp, o_sp)
    if "prefill" in inputs:
        cell = _build(case, "prefill", cells)
        p_sp, b_sp = cell.in_specs
        params, tokens = inputs["prefill"]
        logits, cache = cell.step(
            _tensors(shd.shard_tree(params, p_sp, grid)),
            torch.as_tensor(shd.shard(tokens, b_sp, grid)))
        out["prefill"] = {"logits": _np(logits), "cache": _np(cache)}
        out["specs"]["prefill"] = cell.out_specs
    if "decode" in inputs:
        cell = _build(case, "decode", cells)
        p_sp, kv_sp, tok_sp = cell.in_specs
        params, cache, tokens = inputs["decode"]
        p = _tensors(shd.shard_tree(params, p_sp, grid))
        c = _tensors(shd.shard_tree(cache, kv_sp, grid))
        logits = []
        for tok in tokens:
            lg, c = cell.step(p, c, torch.as_tensor(shd.shard(tok, tok_sp,
                                                              grid)))
            logits.append(_np(lg))
        out["decode"] = {"logits": logits, "cache": _np(c)}
        out["specs"]["decode"] = cell.out_specs
    return out


def rank_main(rank: int, store_path: str, in_path: str, out_dir: str,
              world: int) -> None:
    """Every case on this rank -> ``rank<r>.pkl`` in ``out_dir``: {case
    name: run_case's output, with the seconds it took}."""
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
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def run_ranks(nprocs: int, args: tuple, deadline_s: float) -> None:
    """``rank_main`` on ``nprocs`` spawned ranks (``tests/cells_ranks.py``'s
    launcher: a failure or the deadline kills the rest and fails)."""
    cells_ranks.run_ranks(nprocs, args + (nprocs,), deadline_s, rank_main)


def gathered(results: list[dict], name: str, grid_shape: tuple) -> dict:
    """The ranks' shares of case ``name`` put back together: the train
    step's loss (rank 0's), parameters and AdamW state; the prefill's
    logits and cache; each decode step's logits and the last cache."""
    pd, pm = grid_shape
    grid = shd.Grid(pd, pm, 0, None, None)
    first = results[0][name]
    out: dict = {}
    if "train" in first:
        p_sp, o_sp = first["specs"]["train"]
        tr = [r[name]["train"] for r in results]
        out["train"] = {"loss": [t["loss"] for t in tr],
                        "params": shd.gather_tree(
                            [t["params"] for t in tr],
                            shd.flat_specs(p_sp), grid)}
        for k in ("m", "v", "master"):
            out["train"][k] = shd.gather_tree([t[k] for t in tr], o_sp[k],
                                              grid)
    if "prefill" in first:
        lg_sp, kv_sp = first["specs"]["prefill"]
        pf = [r[name]["prefill"] for r in results]
        out["prefill"] = {
            "logits": shd.gather_tree([p["logits"] for p in pf], lg_sp,
                                      grid),
            "cache": shd.gather_tree([p["cache"] for p in pf], kv_sp, grid)}
    if "decode" in first:
        lg_sp, kv_sp = first["specs"]["decode"]
        dc = [r[name]["decode"] for r in results]
        out["decode"] = {
            "logits": [shd.gather_tree([d["logits"][i] for d in dc], lg_sp,
                                       grid)
                       for i in range(len(dc[0]["logits"]))],
            "cache": shd.gather_tree([d["cache"] for d in dc], kv_sp, grid)}
    return out
