"""The cells of ``repro_torch.launch.steps`` (``Cell``, ``build_cell``,
``all_cells``) and ``launch.mesh``, held to ``repro.launch.steps`` on the
CPU.

* ``all_cells()`` names the reference's 60 pairs in its order;
* for each of the 60, ``abstract_inputs`` equal the reference cell's on a
  1 x 1 host mesh leaf by leaf (path, shape, dtype), and ``donate`` and
  ``meta`` equal the reference's;
* one step of a cell of every family and kind at the smoke config (12
  cases), the port's ``cell.step`` beside the reference's ``cell.step``
  jitted on a 1 x 1 mesh: the port's inputs from ``make_inputs(seed,
  "cpu")``, the same numbers handed to JAX, the parameters the
  reference's own init through ``repro_torch.convert``; every output leaf
  compared (losses at rtol 1e-5, the rest at 1e-4 x each leaf's max;
  the dyngnn cells' bf16 all-to-all payloads at :data:`BF16_PAYLOAD_TOL`);
  the dyngnn cells over a one-rank gloo group of this process;
* ``make_inputs`` against ``abstract_inputs``, ``make_state`` against
  ``make_inputs``' own draw, the dyngnn graphs' padding, the decode
  cache's length, the launch law of the dyngnn cells and the refusals;
* the dyngnn cells over a 2 x 1 grid of spawned gloo ranks
  (``tests/cells_ranks.py``) against the one-rank cells, AdamW's moments
  included.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as jregistry
from repro.core import models as jmodels
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.models import din as jdin
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.core.models import ParamTree
from repro_torch.dist.sharding import Grid
from repro_torch.kernels.mproduct import ops as mp_ops
from repro_torch.kernels.segment_spmm import ops as spmm_ops
from repro_torch.launch import mesh, steps
from repro_torch.optim import adamw

#: a step's output leaves against the reference's, as a fraction of each
#: leaf's max |value| (ROADMAP's side-workload tolerance); losses rtol
TOL, LOSS_TOL = 1e-4, 1e-5
#: the dyngnn cells cast each all-to-all payload to bf16 on both sides; a
#: payload element whose f32 value differs in its last bits across the
#: frameworks can round to the neighbouring bf16 value (2^-8 of it).  Over
#: seeds 0-9 the worst leaf was TM-GCN's layer-0 bias in AdamW's v at
#: 2.6e-3 of its max (v holds the gradient squared: twice its relative
#: error); losses within 2e-6.  Held at 1e-2 (x each leaf's max, losses
#: relative), 5x tighter than tests/test_torch_partition.py's 5e-2
BF16_PAYLOAD_TOL = 1e-2

CELLS = steps.all_cells()

#: one cell of every family and kind, cut to the smoke size
SMOKE = {
    "lm-train": ("yi-6b", "train_4k", {"seq_len": 16, "global_batch": 2}),
    "lm-prefill": ("yi-6b", "prefill_32k",
                   {"seq_len": 16, "global_batch": 2}),
    "lm-decode": ("yi-6b", "decode_32k", {"seq_len": 32, "global_batch": 2}),
    "gnn-full_graph": ("gatedgcn", "full_graph_sm",
                       {"n_nodes": 24, "n_edges": 60, "d_feat": 7,
                        "num_classes": 3}),
    "gnn-minibatch": ("pna", "minibatch_lg",
                      {"batch_nodes": 4, "fanouts": (3, 2), "d_feat": 7,
                       "num_classes": 3}),
    "gnn-molecule": ("schnet", "molecule",
                     {"n_nodes": 8, "n_edges": 16, "batch": 3,
                      "d_feat": 6}),
    "din-train": ("din", "train_batch", {"batch": 16}),
    "din-serve": ("din", "serve_p99", {"batch": 8}),
    "din-retrieval": ("din", "retrieval_cand", {"n_candidates": 100}),
    "dyngnn-tmgcn": ("tmgcn", "dtdg_epinions", None),
    "dyngnn-cdgcn": ("cdgcn", "dtdg_epinions", None),
    "dyngnn-evolvegcn": ("evolvegcn", "dtdg_epinions", None),
}
DYN = {"n_nodes": 64, "n_steps": 16, "edges_per_snap": 192}
TRAIN_KINDS = {"train", "full_graph", "minibatch", "molecule",
               "recsys_train", "dtdg_train"}


@pytest.fixture(scope="module")
def grid():
    """A one-rank gloo group of this process, as a 1 x 1 grid."""
    opened = not dist.is_initialized()
    g = mesh.join_one_rank("cpu")
    yield g
    if opened:
        dist.destroy_process_group()


def _key(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def jleaves(tree) -> dict:
    """{path: leaf} of a JAX tree, the path as ``steps.input_leaves``
    writes it."""
    return {".".join(_key(k) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# ------------------------------------------------------------ the cells --

def test_all_cells_are_the_references():
    assert CELLS == jsteps.all_cells()
    assert len(CELLS) == 60


def test_all_cells_keep_the_order_whichever_config_comes_first():
    """A process that imports the dyngnn configs before any other (as
    ``chip_smoke.py`` does) still lists the cells in the reference's
    order."""
    import ast
    import os
    import subprocess
    import sys

    code = ("import repro_torch.configs.din, repro_torch.configs.paper_dyngnn"
            "\nfrom repro_torch.launch import steps\n"
            "print(steps.all_cells())")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert ast.literal_eval(out.strip()) == jsteps.all_cells()


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_abstract_inputs_equal_the_references(grid, arch, shape):
    ref = jsteps.build_cell(arch, shape, jmake_host_mesh(1, 1))
    cell = steps.build_cell(arch, shape, grid, device="cpu")
    got = steps.input_leaves(cell.abstract_inputs)
    want = jleaves(ref.abstract_inputs)
    assert got.keys() == want.keys()
    for path, a in want.items():
        t = got[path]
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(a.shape), path
        assert str(t.dtype).removeprefix("torch.") == str(a.dtype), path
    assert tuple(cell.donate) == tuple(ref.donate)
    assert cell.meta == ref.meta
    assert (cell.arch_id, cell.shape_name) == (arch, shape)


def test_non_dyngnn_cells_take_one_rank(grid):
    """The non-dyngnn cells take one rank (``None``) or a grid whose
    shape divides as the reference's specs need: DIN's vocab over 3 model
    ranks is refused, over 2 data ranks its cell builds."""
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        steps.build_cell("din", "serve_p99", Grid(1, 3, 0, None, None),
                         device="cpu")
    wide = steps.build_cell("din", "serve_p99", Grid(2, 1, 0, None, None),
                            device="cpu")
    assert wide.out_specs == (("data",), None)
    steps.build_cell("din", "serve_p99", None, device="cpu")
    with pytest.raises(ValueError, match="process group"):
        steps.build_cell("tmgcn", "dtdg_epinions", None, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            steps.build_cell("din", "serve_p99")


def test_make_host_mesh_on_one_gloo_rank(grid):
    g = mesh.make_host_mesh(1, 1)
    assert (g.pd, g.pm, g.rank) == (1, 1, 0)
    assert mesh.mesh_device_count(g) == 1
    assert dist.get_world_size(g.data) == dist.get_world_size(g.model) == 1
    for data, model in ((2, 1), (1, 2), (2, 2)):
        with pytest.raises(ValueError, match="the process group has 1"):
            mesh.make_host_mesh(data, model)


# ------------------------------------------------- one step of each kind --

def _cells(name: str, grid):
    arch, shape, override = SMOKE[name]
    override = override or DYN
    ref = jsteps.build_cell(arch, shape, jmake_host_mesh(1, 1), smoke=True,
                            shape_override=override)
    cell = steps.build_cell(arch, shape, grid, smoke=True,
                            shape_override=override, device="cpu")
    return ref, cell


def _jax_params(cell, ref):
    """The reference's own init of the cell's arch (key 0)."""
    jcfg = jregistry.get_arch(cell.arch_id).make_smoke_config()
    key = jax.random.PRNGKey(0)
    if cell.family == "lm":
        return jlm.init_lm_params(key, jcfg)
    if cell.family == "recsys":
        return jdin.init_params(key, jcfg)
    if cell.family == "gnn":
        d = cell.shape.dims
        return jsteps._gnn_init_fn(cell.arch_id, jcfg, d["d_feat"],
                                   d["num_classes"])()
    return jmodels.init_params(key, dataclasses.replace(
        jcfg, num_nodes=ref.meta["nodes"], num_steps=ref.meta["steps"]))


def _port_params(cell, jparams, train: bool):
    tree = jax.tree.map(np.asarray, jparams)
    if cell.family in ("gnn", "dyngnn"):
        return convert.params_from_jax(tree)
    out = (convert.din_params_from_jax(tree) if cell.family == "recsys"
           else convert.lm_params_from_jax(tree))
    return ParamTree(out) if train else out


def run_both(name: str, grid, seed: int = 0) -> tuple[dict, dict, object]:
    """One step of the port's cell and of the reference's from the same
    inputs -> ({path: port output}, {path: reference output}, cell)."""
    ref, cell = _cells(name, grid)
    train = cell.kind in TRAIN_KINDS
    inputs = list(cell.make_inputs(seed, "cpu"))
    have = steps.input_leaves(inputs)
    want = steps.input_leaves(cell.abstract_inputs)
    assert have.keys() == want.keys()
    for k, t in want.items():
        assert (have[k].shape, have[k].dtype) == (t.shape, t.dtype), k
    jparams = _jax_params(cell, ref)
    inputs[0] = _port_params(cell, jparams, train)
    if train:
        jopt = jadamw.init_state(jparams)
        inputs[1] = adamw.init_state(inputs[0])
    flat = {k: _np(v) for k, v in steps.input_leaves(inputs).items()}
    jargs = list(jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(flat[".".join(_key(k) for k in p)]),
        ref.abstract_inputs))
    jargs[0] = jparams
    if train:
        jargs[1] = jopt
    mesh_ = jmake_host_mesh(1, 1)
    with mesh_:
        jout = jax.jit(ref.step, in_shardings=ref.in_shardings,
                       out_shardings=ref.out_shardings)(*jargs)
    out = cell.step(*inputs)
    got = {k: _np(v) for k, v in steps.input_leaves(out).items()}
    return got, {k: np.asarray(v) for k, v in jleaves(jout).items()}, cell


def _close(got: dict, want: dict, tol: float, loss_tol: float,
           loss_key: str | None) -> float:
    """Every leaf within ``tol`` x its max |value| (the loss within
    ``loss_tol`` relative; integers equal) -> the worst ratio seen."""
    assert got.keys() == want.keys()
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        g, w = g.astype(np.float64), w.astype(np.float64)
        if k == loss_key:
            err = abs(float(g) - float(w)) / abs(float(w))
            assert err <= loss_tol, (k, float(g), float(w))
            worst = max(worst, err / loss_tol * tol)
            continue
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max()) / scale
        assert err <= tol, (k, err)
        worst = max(worst, err)
    return worst


@pytest.mark.parametrize("name", list(SMOKE))
def test_one_step_matches_the_reference_cell(grid, name):
    got, want, cell = run_both(name, grid)
    train = cell.kind in TRAIN_KINDS
    if cell.family == "dyngnn":
        _close(got, want, BF16_PAYLOAD_TOL, BF16_PAYLOAD_TOL, "2")
        assert np.isfinite(got["2"]) and 0.5 < float(got["2"]) < 1.0
    else:
        _close(got, want, TOL, LOSS_TOL, "2" if train else None)
    if train:
        assert int(got["1.step"]) == 1


def test_decode_inputs_carry_a_full_random_cache(grid):
    cell = steps.build_cell("yi-6b", "decode_32k", None, smoke=True,
                            shape_override={"seq_len": 32,
                                            "global_batch": 3},
                            device="cpu")
    params, cache, token = cell.make_inputs(5, "cpu")
    assert cache["len"].tolist() == [31, 31, 31]
    assert float(cache["k"].std()) > 0.5 and float(cache["v"].std()) > 0.5
    assert 0 <= int(token.min()) and int(token.max()) < \
        cell.config.vocab_size
    logits, out = cell.step(params, cache, token)
    assert out["k"] is cache["k"]             # written in place
    assert out["len"].tolist() == [32, 32, 32]
    assert bool(torch.isfinite(logits).all())


def test_dyngnn_inputs_pad_as_dtdg_does(grid):
    cell = steps.build_cell("tmgcn", "dtdg_epinions", grid, smoke=True,
                            shape_override=DYN, device="cpu")
    params, opt, frames, edges, ew, labels = cell.make_inputs(1, "cpu")
    n, e_real = DYN["n_nodes"], DYN["edges_per_snap"]
    e_pad = cell.meta["edges_per_snap"]
    assert e_pad == 1024 and edges.shape[2] == e_pad
    loops = edges[:, :, e_real:e_real + n]
    assert (loops[..., 0] == torch.arange(n)).all()
    assert (loops[..., 1] == torch.arange(n)).all()
    assert (edges[:, :, e_real + n:] == 0).all()
    assert (ew[:, :, e_real + n:] == 0).all()
    assert (ew[:, :, :e_real + n] > 0).all()
    assert int(edges.min()) >= 0 and int(edges.max()) < n
    assert set(labels.unique().tolist()) <= {0, 1}
    # the same seed draws the same graph
    again = cell.make_inputs(1, "cpu")
    assert torch.equal(again[3], edges) and torch.equal(again[4], ew)


@pytest.mark.parametrize("model", ["tmgcn", "cdgcn", "evolvegcn"])
def test_dyngnn_cell_launch_law(grid, model):
    """Per step of T steps in nb blocks, L layers: the aggregate L T
    forward, L T in the recompute, T backward (layer 1's input needs
    none); TM-GCN's band 2 L nb (the fused final layer's loss lies inside
    the block, so the recompute reaches its band too) and its transpose L
    nb; 2 T CSR builds.  ``chip_smoke.py`` reads these counts on the card
    (T = 512, nb 4: 2,560 / 16 / 8)."""
    calls = {"spmm": 0, "ttm": 0, "ttm_t": 0}
    patched = [(spmm_ops, "segment_spmm_csr_ref", "spmm"),
               (mp_ops, "banded_ttm_ref", "ttm"),
               (mp_ops, "banded_ttm_t_ref", "ttm_t")]
    saved = [getattr(m, n) for m, n, _ in patched]

    def counted(key, fn):
        def call(*a):
            calls[key] += 1
            return fn(*a)
        return call

    try:
        for (m, n, key), fn in zip(patched, saved, strict=True):
            setattr(m, n, counted(key, fn))
        cell = steps.build_cell(model, "dtdg_epinions", grid,
                                shape_override=DYN, device="cpu")
        inputs = cell.make_inputs(0, "cpu")
        spmm_ops.csr_builds = 0
        cell.step(*inputs)
    finally:
        for (m, n, _), fn in zip(patched, saved, strict=True):
            setattr(m, n, fn)
    t, nb, layers = DYN["n_steps"], cell.config.checkpoint_blocks, 2
    band = model == "tmgcn"
    assert calls == {"spmm": (2 * layers + 1) * t,
                     "ttm": 2 * layers * nb if band else 0,
                     "ttm_t": layers * nb if band else 0}
    assert spmm_ops.csr_builds == 2 * t


def test_dyngnn_cells_on_two_gloo_ranks_match_one(grid, tmp_path):
    """The dyngnn cell over a 2 x 1 grid of spawned gloo ranks, each rank
    stepping its share of ``make_inputs(0)`` (its steps of each block,
    its vertices' fused labels), equals the one-rank cell on the whole
    arrays, for all three models: the loss at rtol 1e-5; the updated
    parameters and AdamW's ``m`` (``(1 - b1)`` x the clipped gradient:
    a rank whose gradient missed the all-reduce holds its share alone),
    ``v`` and ``master`` at 1e-4 x each leaf's max; the step count
    equal.  The first step moves a parameter by ~lr x warmup, under the
    parameters' limit, so ``m`` and ``v`` are what hold the exchange."""
    import pickle

    import cells_ranks

    cells_ranks.run_ranks(2, (str(tmp_path / "store"), str(tmp_path), 2,
                              DYN), deadline_s=150)
    with open(tmp_path / "ranks.pkl", "rb") as f:
        two = pickle.load(f)
    for model in cells_ranks.MODELS:
        cell = steps.build_cell(model, "dtdg_epinions", grid,
                                shape_override=DYN, device="cpu")
        params, opt, loss = cell.step(*cell.make_inputs(0))
        np.testing.assert_allclose(two[model]["loss"], float(loss),
                                   rtol=LOSS_TOL, err_msg=model)
        one = {k: _np(t) for k, t in
               steps.input_leaves((params, opt)).items()}
        got = two[model]["state"]
        assert got.keys() == one.keys()
        assert {k.split(".")[1] for k in one if k.startswith("1.")} == {
            "m", "v", "master", "step"}
        for k, w in one.items():
            if not np.issubdtype(w.dtype, np.floating):
                np.testing.assert_array_equal(got[k], w, err_msg=k)
                continue
            np.testing.assert_allclose(
                got[k], w, rtol=0, atol=TOL * float(np.abs(w).max()),
                err_msg=f"{model} {k}")


@pytest.mark.parametrize("name", ["lm-train", "gnn-molecule", "din-train",
                                  "dyngnn-tmgcn"])
def test_make_state_is_make_inputs_own_draw(grid, name):
    """A train cell's ``make_state(seed)`` draws the parameters and AdamW
    state that ``make_inputs(seed)`` starts from, to the bit."""
    _, cell = _cells(name, grid)
    want = steps.input_leaves(cell.make_inputs(3, "cpu")[:2])
    got = steps.input_leaves(cell.make_state(3, "cpu"))
    assert got.keys() == want.keys() and got
    for k, w in want.items():
        assert torch.equal(got[k], w), k


def test_serve_cells_have_no_train_state(grid):
    for name in ("lm-decode", "lm-prefill", "din-serve", "din-retrieval"):
        assert _cells(name, grid)[1].make_state is None, name

