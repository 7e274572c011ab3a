"""DIN's cells over ranks held to the JAX package on the CPU.

* The rank runs: one module-scoped session of four spawned gloo ranks
  (``tests/gnn_din_ranks.py``) runs each case's cell at the smoke config
  (f32; vocabularies 1,000 / 100 / 1,000) from its slices of one init
  (the port's, seed 0, given to both packages) and one batch: a train
  step with the tables split over model 2 (2 x 2) and 4 (1 x 4) and
  whole (4 x 1), the serve step with its rows split (2 x 2) and, at a
  batch of 2 < 4 data ranks, whole (4 x 1), and the retrieval with its
  candidates split over data and the tables over model 2 and 4.  The
  gathered loss, parameters, AdamW state, logits and scores are held to
  the reference's cell jitted with its shardings on a 4-device host mesh
  of the same shape.  Rank 0 also runs the first case over a one-rank
  group's 1 x 1 grid and with no grid: bit for bit.
* A vocabulary the model axis does not divide is refused; a rank's
  ``make_inputs`` is the 1 x 1 draw sliced by ``in_specs``; the launcher
  under ``torchrun`` on 4 CPU ranks trains ``din`` to the one-process
  losses.

Tolerances: ``tests/ranks_parity.py``'s; logits and scores 1e-5 (abs and
rel: a lookup's sum over the model row adds zeros).  The spec trees and
the per-rank reckoning are in ``tests/test_torch_grid_specs.py``.
"""

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
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro_torch.configs import registry
from repro_torch.configs.registry import ShapeSpec
from repro_torch.core.models import ParamTree
from repro_torch.dist import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import din
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parent.parent


def test_a_vocabulary_the_model_axis_does_not_divide_is_refused():
    """10,000 categories over 32 model ranks (the 1,000,000 items and
    users split), and a train batch of 16 over 3 data ranks, do not split
    as the reference's specs need."""
    with pytest.raises(ValueError, match="cate_vocab 10000 does not split"):
        steps.build_cell("din", "serve_p99",
                         shd.Grid(1, 32, 0, None, None), device="cpu")
    with pytest.raises(ValueError, match="batch 16 does not split"):
        steps.build_cell("din", "train_batch", shd.Grid(3, 1, 0, None, None),
                         smoke=True, shape_override={"batch": 16},
                         device="cpu")


# -------------------------------------------------------------- runs -----

CASES = {
    "train-2x2": {"shape": "train_batch", "grid": (2, 2),
                  "override": {"batch": 16}},
    "train-1x4": {"shape": "train_batch", "grid": (1, 4),
                  "override": {"batch": 16}},
    "train-4x1": {"shape": "train_batch", "grid": (4, 1),
                  "override": {"batch": 16}},
    "serve-2x2": {"shape": "serve_p99", "grid": (2, 2),
                  "override": {"batch": 8}},
    "serve-small-4x1": {"shape": "serve_p99", "grid": (4, 1),
                        "override": {"batch": 2}},
    "retrieval-2x2": {"shape": "retrieval_cand", "grid": (2, 2),
                      "override": {"n_candidates": 64}},
    "retrieval-1x4": {"shape": "retrieval_cand", "grid": (1, 4),
                      "override": {"n_candidates": 64}},
}
for _case in CASES.values():
    _case["arch"] = "din"

BATCH_KEYS = ("user_id", "hist_items", "hist_cates", "hist_mask",
              "target_item", "target_cate")


def _shape(case: dict) -> ShapeSpec:
    base = registry.get_arch("din").shapes[case["shape"]]
    return ShapeSpec(base.name, base.kind, {**base.dims, **case["override"]})


def _inputs(case: dict) -> tuple[tuple, tuple]:
    """(the reference cell's inputs, the ranks' inputs): one init (the
    port's, seed 0), for a train step a fresh AdamW state, and the
    batch."""
    cfg = registry.get_arch("din").make_smoke_config()
    shape = _shape(case)
    tree = din.init_params(torch.Generator().manual_seed(0), cfg)
    nparams = gnn_din_ranks.tree_numpy(tree)
    jparams = jax.tree.map(jnp.asarray, nparams)
    arrays = steps.din_batch_arrays(cfg, shape, seed=3)
    batch = {k: arrays[k] for k in BATCH_KEYS}
    if shape.kind == "recsys_train":
        opt = gnn_din_ranks._np(adamw.init_state(ParamTree(tree)))
        opt["step"] = np.zeros((), np.int32)
        zeros = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), nparams)
        jopt = {"m": zeros, "v": zeros, "master": jparams,
                "step": jnp.zeros((), jnp.int32)}
        return ((jparams, jopt, batch, arrays["labels"]),
                (nparams, opt, batch, arrays["labels"]))
    if shape.kind == "retrieval":
        cands = (arrays["cand_items"], arrays["cand_cates"])
        return (jparams, batch, *cands), (nparams, batch, *cands)
    return (jparams, batch), (nparams, batch)


def _reference(case: dict, inputs: tuple) -> dict:
    mesh = jmake_host_mesh(*case["grid"])
    jcell = jsteps.build_cell("din", case["shape"], mesh, smoke=True,
                              shape_override=case["override"])
    fn = jax.jit(jcell.step, in_shardings=jcell.in_shardings,
                 out_shardings=jcell.out_shardings)
    with mesh:
        out = fn(*inputs)
    if _shape(case).kind != "recsys_train":
        return {"out": np.asarray(out)}
    p, o, loss = out
    return {"loss": float(loss), "params": flat(p),
            **{k: flat(o[k]) for k in ("m", "v", "master")}}


def _one_process(case: dict, inputs: tuple) -> dict:
    """The port's one-process train step on the global batch -> its v."""
    params = ParamTree(gnn_din_ranks._tensors(inputs[0]))
    opt = gnn_din_ranks._tensors(inputs[1])
    _, o, _ = steps.din_train_step()(
        params, opt, gnn_din_ranks._tensors(inputs[2]),
        torch.as_tensor(inputs[3]))
    return {"v": gnn_din_ranks._np(o["v"])}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on one session of 4 gloo ranks -> (the gathered
    outputs, the reference's, the one-rank check, the port's
    one-process ``v`` of each train case)."""
    inputs = {n: _inputs(c) for n, c in CASES.items()}
    got, one, _ = gnn_din_ranks.session(
        CASES, {n: inputs[n][1] for n in CASES},
        tmp_path_factory.mktemp("din_ranks"), 240)
    want = {n: _reference(c, inputs[n][0]) for n, c in CASES.items()}
    alone = {n: _one_process(c, inputs[n][1]) for n, c in CASES.items()
             if c["shape"] == "train_batch"}
    return got, want, one, alone


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_match_the_reference_cell(ranks, name):
    got, want = ranks[0][name], ranks[1][name]
    if "out" in want:
        assert got["out"].shape == want["out"].shape
        np.testing.assert_allclose(got["out"], want["out"], rtol=TOL,
                                   atol=TOL, err_msg=name)
    else:
        check_train(got, want, name, ranks[3][name])


def test_a_one_rank_grid_is_the_one_rank_step_bit_for_bit(ranks):
    assert ranks[2] is True


@pytest.mark.parametrize("shape,pd,pm,over", [
    ("train_batch", 2, 2, {"batch": 16}), ("serve_p99", 4, 1, {"batch": 2}),
    ("retrieval_cand", 1, 4, {"n_candidates": 64})])
def test_make_inputs_is_the_draw_sliced(shape, pd, pm, over):
    """A rank's ``make_inputs(seed)`` is the 1 x 1 draw sliced by the
    cell's ``in_specs``, every leaf."""
    from repro_torch.launch import dryrun
    one = steps.build_cell("din", shape, None, smoke=True,
                           shape_override=over, device="cpu")
    whole = steps.input_leaves(one.make_inputs(4))
    for r in range(pd * pm):
        grid = shd.Grid(pd, pm, r, None, None)
        cell = steps.build_cell("din", shape, grid, smoke=True,
                                shape_override=over, device="cpu")
        specs = dryrun.flat_in_specs(cell.in_specs)
        got = steps.input_leaves(cell.make_inputs(4))
        assert got.keys() == whole.keys()
        for k, t in got.items():
            assert torch.equal(t, shd.shard(whole[k], specs[k], grid)), k


def test_torchrun_launcher_trains_din_on_four_ranks():
    """``torchrun --nproc-per-node 4 ... --arch din --data-parallel 2``:
    a 2 x 2 grid (the tables over model 2) over the reference's smoke batch
    of 16 x 2 examples; rank 0 alone prints, and its losses equal the
    one-process launcher's on the same batch."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    args = ["-m", "repro_torch.launch.train", "--arch", "din",
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
