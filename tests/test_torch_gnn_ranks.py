"""The static-GNN cells over ranks held to the JAX package on the CPU.

* The rank runs: one module-scoped session of four spawned gloo ranks
  (``tests/gnn_din_ranks.py``) takes one train step of each case's cell at
  the smoke configs (f32; EquiformerV2's cut to one layer at l_max 2),
  each rank from its slices of one init (the port's, seed 0, given to
  both packages) and the batch the reference's cell takes; the gathered
  loss, parameters and AdamW ``m`` / ``v`` / ``master`` are held to the
  reference's cell jitted with its ``in_shardings`` / ``out_shardings``
  on a 4-device host mesh of the same shape (a full graph's 2 x 2 run to
  the 4 x 1 mesh's, on the same inputs).  The cases: every arch's full
  graph on 4 x 1 and 2 x 2 (edge lanes over data; EquiformerV2's node
  rows too, 22 nodes rounded to 24 at 4 ranks, two padded rows with
  ``node_mask`` 0; rank 3's lanes all padding at 4 x 1), PNA with a node
  whose in-edges all sit on one rank and an isolated node (the max, min
  and std fills), every arch's ``minibatch`` at 4 x 1 and ``molecule``
  at 2 x 2 (one replica a data rank).  Rank 0 also runs the first case
  over a one-rank group's 1 x 1 grid and with no grid: bit for bit.
* A rank's ``make_inputs`` is the 1 x 1 draw sliced by ``in_specs``; the
  launcher under ``torchrun`` on 4 CPU ranks trains ``gatedgcn`` to the
  one-process losses.

Tolerances: ``tests/ranks_parity.py``'s.  The spec trees and the per-rank
reckoning are in ``tests/test_torch_grid_specs.py``.
"""


import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnn_din_ranks
from ranks_parity import TOL, check_train, flat
from repro.configs import registry as jregistry
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro_torch.configs import registry
from repro_torch.configs.registry import ShapeSpec
from repro_torch.core.models import ParamTree
from repro_torch.dist import sharding as shd
from repro_torch.launch import steps
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("gatedgcn", "pna", "schnet", "equiformer-v2")


# -------------------------------------------------------------- runs -----

FULL = {"n_nodes": 24, "n_edges": 300, "d_feat": 7, "num_classes": 3}
#: EquiformerV2's smoke config cut to one layer at l_max 2 (its
#: reference cells are the slowest to compile)
EQ_CONFIG = {"n_layers": 1, "l_max": 2}
#: a full graph's 2 x 2 run is held to the 4 x 1 reference (the same
#: rounded inputs, 24 rows and 512 lanes), but EquiformerV2's: 22 nodes
#: are 24 rows at 4 ranks (two padded) and 22 at 2
CASES = {
    **{f"{a}-full-{pd}x{pm}": {
        "arch": a, "shape": "full_graph_sm", "grid": (pd, pm),
        "override": dict(FULL, n_nodes=22) if a == "equiformer-v2"
        else FULL} for a in ARCHS for pd, pm in ((4, 1), (2, 2))},
    **{f"{a}-minibatch-4x1": {
        "arch": a, "shape": "minibatch_lg", "grid": (4, 1),
        "override": {"batch_nodes": 8, "fanouts": (3, 2), "d_feat": 7,
                     "num_classes": 3}} for a in ARCHS},
    **{f"{a}-molecule-2x2": {
        "arch": a, "shape": "molecule", "grid": (2, 2),
        "override": {"n_nodes": 8, "n_edges": 16, "batch": 4, "d_feat": 6,
                     "num_classes": 2}} for a in ARCHS},
}
for _name, _case in CASES.items():
    if _case["arch"] == "equiformer-v2":
        _case["config"] = EQ_CONFIG
    elif _name.endswith("full-2x2"):
        _case["same_as"] = _name.replace("2x2", "4x1")


def _shape(case: dict) -> ShapeSpec:
    base = jregistry.get_arch(case["arch"]).shapes[case["shape"]]
    return ShapeSpec(base.name, base.kind, {**base.dims, **case["override"]})


def _pna_fills(a: dict, lanes: int) -> None:
    """Node 3 isolated; node 2's in-edges all in lanes ``lanes`` to ``2 x
    lanes``: rank 1's at 4 x 1, rank 0's at 2 x 2."""
    e = a["edges"]
    real = a["edge_mask"] > 0
    e[real & (e[:, 0] == 3), 0] = 4
    e[real & (e[:, 1] == 3), 1] = 5
    inside = np.zeros_like(real)
    inside[lanes:2 * lanes] = True
    e[real & ~inside & (e[:, 1] == 2), 1] = 6
    e[lanes + 2:lanes + 8, 1] = 2
    e[lanes + 2:lanes + 8, 0] = 7
    loops = real & (e[:, 0] == e[:, 1])
    e[loops, 1] = np.where(e[loops, 0] == 8, 9, 8)


def _batch(case: dict) -> list:
    """The batch inputs of the case's cell (whole, numpy), as the
    reference's cell takes them."""
    shape = _shape(case)
    pd = case["grid"][0]
    keys = ["edges", "edge_mask", "node_feat", "positions", "labels",
            "node_mask"]
    if shape.kind == "full_graph":
        a = steps.gnn_replica_arrays(shape, pd, seed=3)
        if case["arch"] == "pna":
            _pna_fills(a, 128)      # 4 x 1's lanes a rank
        return [a[k] for k in keys]
    reps = [steps.gnn_replica_arrays(shape, pd, 3, r) for r in range(pd)]
    for a in reps:
        if a["graph_id"] is None:
            a["graph_id"] = np.zeros(a["node_mask"].shape, np.int32)
    return [np.stack([a[k] for a in reps]) for k in keys + ["graph_id"]]


def _inputs(case: dict) -> tuple[tuple, tuple]:
    """(the reference cell's inputs, the ranks' inputs) of one case: the
    port's init (seed 0) as both packages' trees, a fresh AdamW state, and
    the batch."""
    cfg = registry.get_arch(case["arch"]).make_smoke_config()
    cfg = dataclasses.replace(cfg, **case.get("config", {}))
    d = _shape(case).dims
    tree = steps.gnn_init_params(torch.Generator().manual_seed(0),
                                 case["arch"], cfg, d["d_feat"],
                                 d["num_classes"])
    nparams = gnn_din_ranks.tree_numpy(tree)
    params = ParamTree(tree)
    opt = gnn_din_ranks._np(adamw.init_state(params))
    opt["step"] = np.zeros((), np.int32)
    zeros = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), nparams)
    jparams = jax.tree.map(jnp.asarray, nparams)
    jopt = {"m": zeros, "v": zeros, "master": jparams,
            "step": jnp.zeros((), jnp.int32)}
    batch = _batch(case)
    return (jparams, jopt, *batch), (nparams, opt, *batch)


def _reference(case: dict, inputs: tuple) -> dict:
    """The reference cell's outputs, jitted with its shardings on a host
    mesh of the case's grid."""
    mesh = jmake_host_mesh(*case["grid"])
    jcell = jsteps.build_cell(case["arch"], case["shape"], mesh, smoke=True,
                              shape_override=case["override"],
                              config_override=case.get("config"))
    fn = jax.jit(jcell.step, in_shardings=jcell.in_shardings,
                 out_shardings=jcell.out_shardings)
    with mesh:
        p, o, loss = fn(*inputs)
    return {"loss": float(loss), "params": flat(p),
            **{k: flat(o[k]) for k in ("m", "v", "master")}}


def references(cases: dict, inputs: dict, reference) -> dict:
    """Each case's reference outputs; a case ``same_as`` another (the
    same inputs, held to that case's grid's reference) reuses them."""
    want = {}
    for n, case in cases.items():
        if "same_as" in case:
            continue
        want[n] = reference(case, inputs[n][0])
    for n, case in cases.items():
        if "same_as" in case:
            other = inputs[case["same_as"]][1]
            for x, y in zip(jax.tree.leaves(inputs[n][1]),
                            jax.tree.leaves(other), strict=True):
                assert np.array_equal(x, y), n
            want[n] = want[case["same_as"]]
    return want


def _one_process(case: dict, inputs: tuple) -> dict:
    """The port's one-process step (``gnn_train_step``, no grid) on the
    case's global batch: every replica, or the whole graph."""
    shape = _shape(case)
    cfg = dataclasses.replace(
        registry.get_arch(case["arch"]).make_smoke_config(),
        **case.get("config", {}))
    dims = steps.gnn_dims(shape, case["grid"][0])
    params = ParamTree(gnn_din_ranks._tensors(inputs[0]))
    opt = gnn_din_ranks._tensors(inputs[1])
    t = [torch.as_tensor(x) for x in inputs[2:]]
    if shape.kind == "full_graph":
        batches = [GraphBatch(t[0], t[1], t[2], t[5], t[3], None, 1, t[4])]
    else:
        mol = shape.kind == "molecule"
        batches = [GraphBatch(t[0][r], t[1][r], t[2][r], t[5][r], t[3][r],
                              t[6][r] if mol else None,
                              dims["seeds"] if mol else 1, t[4][r])
                   for r in range(t[0].shape[0])]
    step = steps.gnn_train_step(case["arch"], cfg, shape.kind,
                                seeds=dims["seeds"] or None)
    _, o, _ = step(params, opt, batches)
    return {"v": gnn_din_ranks._np(o["v"])}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on one session of 4 gloo ranks -> (the gathered
    outputs, the reference's, the one-rank check, the port's one-process
    ``v``)."""
    inputs = {n: _inputs(c) for n, c in CASES.items()}
    got, one, _ = gnn_din_ranks.session(
        CASES, {n: inputs[n][1] for n in CASES},
        tmp_path_factory.mktemp("gnn_ranks"), 240)
    alone = {n: _one_process(c, inputs[n][1]) for n, c in CASES.items()}
    return got, references(CASES, inputs, _reference), one, alone


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_match_the_reference_cell(ranks, name):
    check_train(ranks[0][name], ranks[1][name], name, ranks[3][name])


def test_a_one_rank_grid_is_the_one_rank_step_bit_for_bit(ranks):
    assert ranks[2] is True


def test_the_cases_reach_the_padding_and_fill_paths():
    """4 x 1 at 300 edges: 512 lanes, rank 3's 128 all padding; PNA's
    node 2 reads lanes of rank 1 alone and node 3 none; EquiformerV2's 22
    nodes rounded to 24, the last two rows masked."""
    case = CASES["pna-full-4x1"]
    edges, emask = _batch(case)[:2]
    assert edges.shape[0] == 512 and not emask[384:].any()
    dst = edges[:, 1][emask > 0]
    lanes = np.flatnonzero(emask > 0)
    assert set(lanes[dst == 2] // 128) == {1}
    assert not (edges[emask > 0] == 3).any()
    eq = _batch(CASES["equiformer-v2-full-4x1"])
    assert eq[2].shape[0] == 24 and eq[5][22:].sum() == 0


@pytest.mark.parametrize("arch,shape,pd,pm", [
    ("gatedgcn", "full_graph_sm", 4, 1), ("equiformer-v2", "full_graph_sm",
                                          2, 2),
    ("pna", "minibatch_lg", 4, 1), ("schnet", "molecule", 2, 2)])
def test_make_inputs_is_the_draw_sliced(arch, shape, pd, pm):
    """A rank's ``make_inputs(seed)``: a full graph's arrays at the grid's
    rounding sliced by ``in_specs``; a replica cell's replica
    ``data_index``, drawn from ``default_rng(seed + data_index)``."""
    over = dict(FULL) if shape == "full_graph_sm" else None
    if shape == "minibatch_lg":
        over = {"batch_nodes": 8, "fanouts": (3, 2), "d_feat": 7,
                "num_classes": 3}
    if shape == "molecule":
        over = {"n_nodes": 8, "n_edges": 16, "batch": 4, "d_feat": 6,
                "num_classes": 2}
    base = jregistry.get_arch(arch).shapes[shape]
    tshape = ShapeSpec(base.name, base.kind, {**base.dims, **over})
    for r in range(pd * pm):
        grid = shd.Grid(pd, pm, r, None, None)
        cell = steps.build_cell(arch, shape, grid, smoke=True,
                                shape_override=over, device="cpu")
        got = cell.make_inputs(5)[2:]
        if base.kind == "full_graph":
            a = steps.gnn_replica_arrays(tshape, pd, 5)
            keys = ["edges", "edge_mask", "node_feat", "positions",
                    "labels", "node_mask"]
            want = [shd.shard(a[k], sp, grid)
                    for k, sp in zip(keys, cell.in_specs[2:], strict=True)]
        else:
            a = steps.gnn_replica_arrays(tshape, pd, 5, grid.data_index)
            keys = ["edges", "edge_mask", "node_feat", "positions",
                    "labels", "node_mask", "graph_id"]
            if a["graph_id"] is None:
                a["graph_id"] = np.zeros_like(a["labels"])
            want = [a[k][None] for k in keys]
        for g, w, k in zip(got, want, keys, strict=True):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


def test_torchrun_launcher_trains_gatedgcn_on_four_ranks():
    """``torchrun --nproc-per-node 4 ... --arch gatedgcn --data-parallel
    2``: a 2 x 2 grid over the reference's smoke batch of 2 x 2 molecule
    graphs, one replica a data rank; rank 0 alone prints, and its losses
    equal the one-process launcher's on the same replicas
    (``--data-parallel 2`` in one process)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    args = ["-m", "repro_torch.launch.train", "--arch", "gatedgcn",
            "--data-parallel", "2", "--steps", "3", "--device", "cpu"]
    ranked = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", *args],
        capture_output=True, text=True, timeout=150, env=env, cwd=ROOT)
    assert ranked.returncode == 0, ranked.stderr[-4000:]
    alone = subprocess.run([sys.executable, *args], capture_output=True,
                           text=True, timeout=120, env=env, cwd=ROOT)
    assert alone.returncode == 0, alone.stderr[-4000:]

    def losses(text):
        return [float(ln.split()[-1]) for ln in text.splitlines()
                if ln.startswith("step ")]

    got, want = losses(ranked.stdout), losses(alone.stdout)
    assert len(want) == 3 and len(got) == 3, ranked.stdout
    assert ranked.stdout.splitlines()[-1] == "done"
    np.testing.assert_allclose(got, want, rtol=TOL)
