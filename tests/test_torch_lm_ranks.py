"""The LM cells over ranks held to the JAX package on the CPU.

* The spec trees: ``launch.steps``' ``_lm_head_specs`` (both modes, every
  branch), ``lm_param_specs``, ``_fsdp_opt_specs``, ``_chunk_constrainer``
  and ``_lm_kv_specs`` (both layouts and the sequence split), and
  ``dist.sharding``'s ``lm_batch_specs`` / ``dp_axes``, equal the
  reference's ``PartitionSpec`` trees leaf by leaf for all five LM archs
  at their full configs, on host meshes of 1 x 1, 1 x 2, 2 x 2, 1 x 4 and
  4 x 1 and on a 16 x 16 stand-in (an object with the mesh's ``shape``
  and ``axis_names``, all the spec functions read).
* The rank runs: one module-scoped session of four spawned gloo ranks
  (``tests/lm_ranks.py``) runs each case's cells -- one train step, a
  prefill and three decode steps -- on a 2 x 2 or 1 x 4 grid at the smoke
  configs (f32), each rank from its slices of the reference's own init;
  the gathered loss, parameters, AdamW ``m`` / ``v`` / ``master``, logits
  and caches are held to the reference's cell jitted with its
  ``in_shardings`` / ``out_shardings`` on a 4-device host mesh of the same
  shape.  The cases reach every layout: heads and KV heads split (Yi at
  2 x 2, Gemma), query heads split with KV heads whole and the cache split
  by rows over the model row (Yi at 1 x 4), heads that do not divide
  (MiniCPM with 6 heads and 2 KV heads at 1 x 4: the chunk hook over 4
  ranks), experts split (OLMoE, Moonlight at 2 x 2) or each expert's
  ``d_ff`` (OLMoE with 6 experts at 1 x 4, capacity factor 0.5, so tokens
  drop), the cache split over every rank (Yi's ``long_500k`` at 2 x 2, its
  slices 2 and 3 empty while rows 14-16 are written), and the vocab-split
  embedding and chunked vocab-parallel loss (Yi, ``loss_chunk`` 16).
* The log-sum-exp merge of four plain slices (one empty), ``convert`` +
  ``shard_tree`` + ``gather_tree`` byte for byte, and the launcher under
  ``torchrun`` on 4 CPU ranks against one process on the same batch.

Tolerances (``tests/test_torch_lm_train.py``'s and ``test_torch_lm.py``'s):
the loss rtol 1e-5; parameters, ``m`` and ``master`` 1e-5 (abs and rel);
``v`` (~g^2) 1e-4 x each leaf's max; logits and caches 1e-4 (abs and
rel).
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import lm_ranks
from repro.configs import registry as jregistry
from repro.dist import sharding as jshd
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.models import lm as jlm
from repro.nn.attention import decode_attention_jnp
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.dist import sharding as shd
from repro_torch.kernels.flash_decode.ops import (decode_attention,
                                                  merge_slices)
from repro_torch.launch import steps
from repro_torch.models import lm

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
LOGITS_TOL = 1e-4
V_TOL = 1e-4
ARCHS = ("yi-6b", "gemma-7b", "minicpm-2b", "olmoe-1b-7b",
         "moonshot-v1-16b-a3b")
GRIDS = ((1, 1), (1, 2), (2, 2), (1, 4), (4, 1), (16, 16))


# ------------------------------------------------------------ specs ------

def _norm(p) -> tuple:
    """A reference ``PartitionSpec`` as the port writes a spec."""
    return tuple(None if e is None else ((e,) if isinstance(e, str)
                                         else tuple(e)) for e in p)


def _ref_flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {".".join(str(k.key) for k in path): _norm(v)
            for path, v in leaves}


def _meshes(pd: int, pm: int):
    """(the reference's mesh, the port's grid stand-in)."""
    grid = shd.Grid(pd, pm, 0, None, None)
    if pd * pm <= len(jax.devices()):
        return jmake_host_mesh(pd, pm), grid
    return types.SimpleNamespace(shape={"data": pd, "model": pm},
                                 axis_names=("data", "model")), grid


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pd,pm", GRIDS)
def test_spec_trees_equal_the_reference(arch, pd, pm):
    jmesh, grid = _meshes(pd, pm)
    jcfg = jregistry.get_arch(arch).make_config()
    cfg = registry.get_arch(arch).make_config()
    for mode in ("gqa_tp", "naive_tp"):
        if mode == "naive_tp" and not (cfg.num_heads % pm == 0 and
                                       cfg.num_kv_heads % pm == 0) \
                and cfg.head_dim % pm:
            continue
        assert shd.flat_specs(steps._lm_head_specs(cfg, grid, mode)) == \
            _ref_flat(jsteps._lm_head_specs(jcfg, jmesh, mode))
    p_specs = steps.lm_param_specs(cfg, grid)
    jp_specs = jsteps.lm_param_specs(jcfg, jmesh)
    assert shd.flat_specs(p_specs) == _ref_flat(jp_specs)
    a_params = jax.eval_shape(lambda: jlm.init_lm_params(
        jax.random.PRNGKey(0), jcfg))
    jo = jsteps._fsdp_opt_specs(a_params, jp_specs, jmesh)
    o = steps._fsdp_opt_specs(lm.lm_param_shapes(cfg), p_specs, grid)
    for k in ("m", "v", "master"):
        assert shd.flat_specs(o[k]) == _ref_flat(jo[k]), k
    assert o["step"] == _norm(jo["step"])
    assert steps.opt_state_specs(o)["m"] == shd.flat_specs(o["m"])
    for seq_shard in (False, True):
        assert shd.flat_specs(steps._lm_kv_specs(cfg, grid, seq_shard)) \
            == _ref_flat(jsteps._lm_kv_specs(jcfg, jmesh, seq_shard))
    assert shd.lm_batch_specs(grid) == _norm(jshd.lm_batch_specs(jmesh))
    assert shd.dp_axes(grid) == jshd.dp_axes(jmesh)
    hook = steps._chunk_constrainer(cfg, grid)
    if isinstance(jmesh, types.SimpleNamespace):
        # the reference's hook builds NamedShardings: a real mesh only
        assert (hook is None) == (jcfg.num_heads % pm == 0)
    else:
        assert (hook is None) == (jsteps._chunk_constrainer(jcfg, jmesh)
                                  is None)
    if hook is not None:
        assert hook["inward"] == (("data",), ("model",), None, None)


def test_the_spec_branches_are_reached():
    """The grids above reach every branch: heads and KV heads divide,
    heads but not KV heads (Yi at 16), neither (MiniCPM's 36 at 16); the
    MoE experts split (64 at 16) or each expert's d_ff (8 experts at
    16)."""
    grid = shd.Grid(16, 16, 0, None, None)
    yi = steps._lm_head_specs(registry.get_arch("yi-6b").make_config(),
                              grid)
    assert yi["wq"][2] == ("model",) and yi["wk"][2] is None
    mini = steps._lm_head_specs(
        registry.get_arch("minicpm-2b").make_config(), grid)
    assert all(all(e is None for e in sp) for sp in mini.values())
    olmoe = registry.get_arch("olmoe-1b-7b").make_config()
    assert steps.lm_param_specs(olmoe, grid)["layers"]["ffn"]["wo"] == \
        (None, ("model",), None, None)
    small = dataclasses.replace(olmoe, moe_experts=8)
    assert steps.lm_param_specs(small, grid)["layers"]["ffn"]["wo"] == \
        (None, None, ("model",), None)
    kv = steps._lm_kv_specs(registry.get_arch("yi-6b").make_config(), grid,
                            False)
    assert kv["k"][2] == ("model",)


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_specs_keep_a_leaf_no_dimension_of_which_divides(arch):
    """``_fsdp_opt_specs`` at 5 data ranks over a smoke config: leaves no
    dimension of which 5 divides keep their parameter spec, the others
    split their largest free one, as the reference's do."""
    jmesh = types.SimpleNamespace(shape={"data": 5, "model": 1},
                                  axis_names=("data", "model"))
    grid = shd.Grid(5, 1, 0, None, None)
    # d_ff 320: the one dimension 5 divides
    jcfg = dataclasses.replace(
        jregistry.get_arch(arch).make_smoke_config(), d_ff=320)
    cfg = dataclasses.replace(registry.get_arch(arch).make_smoke_config(),
                              d_ff=320)
    jp = jsteps.lm_param_specs(jcfg, jmesh)
    a_params = jax.eval_shape(lambda: jlm.init_lm_params(
        jax.random.PRNGKey(0), jcfg))
    want = _ref_flat(jsteps._fsdp_opt_specs(a_params, jp, jmesh)["m"])
    got = shd.flat_specs(steps._fsdp_opt_specs(
        lm.lm_param_shapes(cfg), steps.lm_param_specs(cfg, grid), grid)["m"])
    assert got == want
    flat_p = shd.flat_specs(steps.lm_param_specs(cfg, grid))
    assert any(got[k] == flat_p[k] for k in got)        # kept whole
    assert any(got[k] != flat_p[k] for k in got)        # split over data


@pytest.mark.parametrize("arch,shape,pd,pm", [
    ("yi-6b", "train_4k", 2, 2), ("yi-6b", "decode_32k", 1, 4),
    ("yi-6b", "long_500k", 2, 2), ("olmoe-1b-7b", "prefill_32k", 2, 2),
    ("olmoe-1b-7b", "decode_32k", 2, 2)])
def test_make_inputs_is_the_one_rank_draw_sliced(arch, shape, pd, pm):
    """A rank's ``make_inputs(seed)`` is the 1 x 1 ``make_inputs(seed)``
    sliced by the cell's ``in_specs`` (drawn leaf by leaf, the cache a
    layer at a time): every leaf equal, for every rank."""
    from repro_torch.launch import dryrun
    over = {"seq_len": 32, "global_batch": 4} if shape != "long_500k" \
        else {"seq_len": 64}
    one = steps.build_cell(arch, shape, None, smoke=True,
                           shape_override=over, device="cpu")
    whole = steps.input_leaves(one.make_inputs(3))
    for r in range(pd * pm):
        grid = shd.Grid(pd, pm, r, None, None)
        cell = steps.build_cell(arch, shape, grid, smoke=True,
                                shape_override=over, device="cpu")
        specs = dryrun.flat_in_specs(cell.in_specs)
        got = steps.input_leaves(cell.make_inputs(3))
        assert got.keys() == whole.keys()
        for k, t in got.items():
            assert torch.equal(t, shd.shard(whole[k], specs[k], grid)), k


# -------------------------------------------------------------- runs -----

BT = {"seq_len": 32, "global_batch": 4}
LENS = [5, 9, 20, 13]
CASES = {
    "yi-2x2": {"arch": "yi-6b", "grid": (2, 2),
               "override": {"loss_chunk": 16},
               "shapes": {"train": BT, "prefill": BT, "decode": BT}},
    "yi-1x4": {"arch": "yi-6b", "grid": (1, 4),
               "shapes": {"train": BT, "prefill": BT, "decode": BT}},
    "yi-long-2x2": {"arch": "yi-6b", "grid": (2, 2),
                    "decode_shape": "long_500k", "lens": [14],
                    "shapes": {"decode": {"seq_len": 64,
                                          "global_batch": 1}}},
    "gemma-2x2": {"arch": "gemma-7b", "grid": (2, 2),
                  "shapes": {"train": BT, "prefill": BT, "decode": BT}},
    "minicpm-1x4": {"arch": "minicpm-2b", "grid": (1, 4),
                    "override": {"num_heads": 6, "num_kv_heads": 2,
                                 "q_chunk": 16},
                    "shapes": {"train": BT, "prefill": BT, "decode": BT}},
    "olmoe-2x2": {"arch": "olmoe-1b-7b", "grid": (2, 2),
                  "shapes": {"train": BT, "prefill": BT, "decode": BT}},
    "olmoe-1x4": {"arch": "olmoe-1b-7b", "grid": (1, 4),
                  "override": {"moe_experts": 6,
                               "moe_capacity_factor": 0.5},
                  "shapes": {"train": BT, "prefill": BT, "decode": BT}},
    "moonshot-2x2": {"arch": "moonshot-v1-16b-a3b", "grid": (2, 2),
                     "shapes": {"train": BT, "prefill": BT, "decode": BT}},
}
RUNS = [(name, kind) for name, c in CASES.items() for kind in c["shapes"]]


def _jcell(case: dict, kind: str, mesh):
    shape = {"train": "train_4k", "prefill": "prefill_32k",
             "decode": case.get("decode_shape", "decode_32k")}[kind]
    return jsteps.build_cell(case["arch"], shape, mesh, smoke=True,
                             shape_override=case["shapes"][kind],
                             config_override=case.get("override"))


def _flat(tree) -> dict:
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _reference(case: dict) -> tuple[dict, dict]:
    """(the ranks' inputs: whole numpy trees, the reference's outputs)
    of one case, its cells jitted on a host mesh of the case's grid."""
    mesh = jmake_host_mesh(*case["grid"])
    jcfg = dataclasses.replace(
        jregistry.get_arch(case["arch"]).make_smoke_config(),
        **case.get("override", {}))
    jparams = jlm.init_lm_params(jax.random.PRNGKey(0), jcfg)
    nparams = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(7)
    inputs, want = {}, {}
    for kind in case["shapes"]:
        cell = _jcell(case, kind, mesh)
        fn = jax.jit(cell.step, in_shardings=cell.in_shardings,
                     out_shardings=cell.out_shardings)
        dims = case["shapes"][kind]
        b, s = dims["global_batch"], dims["seq_len"]
        if kind == "train":
            toks, tgts = (rng.integers(0, jcfg.vocab_size, (b, s))
                          .astype(np.int32) for _ in range(2))
            tgts[0, :2] = [-1, jcfg.vocab_size]   # masked targets
            jopt = jadamw.init_state(jparams)
            with mesh:
                p, o, loss = fn(jparams, jopt, toks, tgts)
            _, port_opt = convert.lm_train_state_from_jax(
                nparams, jax.tree.map(np.asarray, jopt))
            inputs["train"] = (
                nparams, {k: (lm_ranks._np(v) if k != "step" else
                              v.numpy()) for k, v in port_opt.items()},
                toks, tgts)
            want["train"] = {"loss": float(loss), "params": _flat(p),
                             **{k: _flat(o[k])
                                for k in ("m", "v", "master")}}
        elif kind == "prefill":
            toks = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
            with mesh:
                logits, cache = fn(jparams, toks)
            inputs["prefill"] = (nparams, toks)
            want["prefill"] = {"logits": np.asarray(logits),
                               "cache": _flat(cache)}
        else:
            kv = (jcfg.num_layers, b, s, jcfg.num_kv_heads, jcfg.head_dim)
            cache = {"k": rng.normal(size=kv).astype(np.float32),
                     "v": rng.normal(size=kv).astype(np.float32),
                     "len": np.asarray(case.get("lens", LENS),
                                       np.int32)}
            toks = [rng.integers(0, jcfg.vocab_size, (b,)).astype(np.int32)
                    for _ in range(lm_ranks.DECODE_STEPS)]
            inputs["decode"] = (nparams, cache, toks)
            logits, jc = [], jax.tree.map(jnp.asarray, cache)
            with mesh:
                for tok in toks:
                    lg, jc = fn(jparams, jc, tok)
                    logits.append(np.asarray(lg))
            want["decode"] = {"logits": logits, "cache": _flat(jc)}
    return inputs, want


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on one session of 4 gloo ranks -> (the gathered
    outputs, the reference's, each case's seconds on rank 0)."""
    d = tmp_path_factory.mktemp("lm_ranks")
    refs = {name: _reference(case) for name, case in CASES.items()}
    with open(d / "in.pkl", "wb") as f:
        pickle.dump({n: (CASES[n], refs[n][0]) for n in CASES}, f)
    lm_ranks.run_ranks(4, (str(d / "store"), str(d / "in.pkl"), str(d)),
                       240)
    res = []
    for r in range(4):
        with open(d / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    got = {n: lm_ranks.gathered(res, n, CASES[n]["grid"]) for n in CASES}
    return got, {n: refs[n][1] for n in CASES}


def _close(got: dict, want: dict, tol: float, name: str) -> None:
    assert got.keys() == want.keys(), name
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=tol, atol=tol,
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("name,kind", RUNS)
def test_ranks_match_the_reference_cell(ranks, name, kind):
    got, want = ranks[0][name][kind], ranks[1][name][kind]
    if kind == "train":
        for loss in got["loss"]:             # every rank: the global loss
            np.testing.assert_allclose(loss, want["loss"], rtol=TOL)
        for k in ("params", "m", "master"):
            _close(got[k], want[k], TOL, f"{name} {k}")
        assert got["v"].keys() == want["v"].keys()
        for k, w in want["v"].items():
            np.testing.assert_allclose(
                got["v"][k], w, rtol=0, atol=V_TOL * float(np.abs(w).max()),
                err_msg=f"{name} v {k}")
    elif kind == "prefill":
        np.testing.assert_allclose(got["logits"], want["logits"],
                                   rtol=LOGITS_TOL, atol=LOGITS_TOL)
        _close(got["cache"], want["cache"], LOGITS_TOL, f"{name} cache")
    else:
        assert len(got["logits"]) == len(want["logits"])
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            np.testing.assert_allclose(g, w, rtol=LOGITS_TOL,
                                       atol=LOGITS_TOL,
                                       err_msg=f"{name} step {i}")
        _close(got["cache"], want["cache"], LOGITS_TOL, f"{name} cache")


# ------------------------------------------------------------ extras -----

def test_lse_merge_of_four_slices_equals_the_unsplit_cache():
    """Four plain slices of a cache (the last empty) merged by their
    log-sum-exps equal the unsplit plain version and
    ``decode_attention_jnp``; an empty slice gives 0 and -inf."""
    rng = np.random.default_rng(3)
    b, s, hq, kvh, d = 2, 64, 8, 2, 32
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, kvh, d)).astype(np.float32)
            for _ in range(2))
    lens = np.array([37, 41], np.int32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    parts = []
    for r in range(4):
        local = torch.from_numpy(np.clip(lens - r * 16, 0, 16)
                                 .astype(np.int32))
        parts.append(decode_attention(tq, tk[:, r * 16:(r + 1) * 16],
                                      tv[:, r * 16:(r + 1) * 16], local,
                                      return_lse=True))
    o3, lse3 = parts[3]
    assert torch.equal(o3, torch.zeros_like(o3))
    assert bool(torch.isneginf(lse3).all())
    merged = merge_slices(torch.stack([p[0] for p in parts]),
                          torch.stack([p[1] for p in parts]))
    whole = decode_attention(tq, tk, tv, torch.from_numpy(lens))
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-6)
    want = decode_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(lens))
    np.testing.assert_allclose(merged.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    _, lse = decode_attention(tq, tk, tv, torch.from_numpy(lens),
                              return_lse=True)
    scores = np.einsum("bhgd,bshd->bhgs", q.reshape(b, kvh, 4, d), k) \
        / np.sqrt(d)
    want_lse = [np.log(np.exp(scores[i, ..., :lens[i]]).sum(-1))
                .reshape(hq) for i in range(b)]
    np.testing.assert_allclose(lse.numpy(), np.stack(want_lse), rtol=1e-5)


def test_convert_shard_and_gather_return_the_jax_tree_bit_for_bit():
    """A bf16 JAX tree through ``convert`` into each rank's shards of a
    2 x 2 grid (``lm_params_from_jax`` with the specs, the same as
    ``shard_tree`` of the converted tree) and put back together with
    ``gather_tree``: byte for byte."""
    jcfg = dataclasses.replace(
        jregistry.get_arch("olmoe-1b-7b").make_smoke_config(),
        dtype=jnp.bfloat16)
    tree = jax.tree.map(np.asarray, jlm.init_lm_params(
        jax.random.PRNGKey(1), jcfg))
    cfg = dataclasses.replace(
        registry.get_arch("olmoe-1b-7b").make_smoke_config(),
        dtype=torch.bfloat16)
    specs = steps.lm_param_specs(cfg, shd.Grid(2, 2, 0, None, None))
    shards = [convert.lm_params_from_jax(tree, specs,
                                         shd.Grid(2, 2, r, None, None))
              for r in range(4)]
    whole = convert.lm_params_from_jax(tree)
    for r in range(4):                # the same as slicing the tensors
        for k, t in shd.shard_tree(whole, specs, shd.Grid(
                2, 2, r, None, None))["layers"]["attn"].items():
            assert torch.equal(t, shards[r]["layers"]["attn"][k]), k
    assert shards[1]["layers"]["ffn"]["wi_gate"].shape[1] == 4  # 8 / 2
    back = shd.gather_tree(shards, specs, shd.Grid(2, 2, 0, None, None))
    for k, w in _flat(tree).items():
        g = back
        for part in k.split("."):
            g = g[part]
        assert g.dtype == torch.bfloat16 or g.dtype == torch.float32, k
        assert g.view(torch.int16 if g.dtype == torch.bfloat16
                      else torch.int32).numpy().tobytes() == \
            w.view(np.int16 if w.dtype.name == "bfloat16"
                   else np.int32).tobytes(), k


def test_torchrun_launcher_trains_an_lm_on_four_ranks():
    """``torchrun --nproc-per-node 4 ... --arch olmoe-1b-7b
    --data-parallel 2``: a 2 x 2 grid over a global batch of 2 x 2
    sequences; rank 0 alone prints, and its losses equal the one-process
    launcher's on the same batch (``--data-parallel 2`` in one
    process)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    args = ["-m", "repro_torch.launch.train", "--arch", "olmoe-1b-7b",
            "--data-parallel", "2", "--steps", "2", "--device", "cpu"]
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
    assert len(want) == 2 and len(got) == 2, ranked.stdout
    assert ranked.stdout.splitlines()[-1] == "done"
    np.testing.assert_allclose(got, want, rtol=TOL)


# ---------------------------------------------------------- dry run ------

LM_CELLS = [(a, s) for a, s in steps.all_cells() if a in ARCHS]


@pytest.mark.parametrize("arch,shape", LM_CELLS)
def test_rank_bytes_are_the_reference_shard_shapes(arch, shape):
    """``launch.dryrun``'s per-rank argument bytes on a 2 x 2 grid equal
    the bytes of the reference's shard shapes (``NamedSharding
    .shard_shape`` of each abstract input under its ``in_shardings``)."""
    from repro_torch.launch import dryrun
    mesh = jmake_host_mesh(2, 2)
    ref = jsteps.build_cell(arch, shape, mesh)
    want = 0
    for a, sh in zip(jax.tree.leaves(ref.abstract_inputs),
                     jax.tree.leaves(ref.in_shardings), strict=True):
        want += int(np.prod(sh.shard_shape(a.shape))) * a.dtype.itemsize
    cell = dryrun.grid_cell(arch, shape, 2, 2, device="cpu")
    rec = dryrun.reckon(cell, 85_017_493_504, cell.layout.grid)
    assert rec["arg_bytes"] == want
    assert rec["grid"] == [2, 2]


def test_the_smallest_grids_of_the_lm_cells_one_h100_cannot_hold():
    """The 18 LM cells one H100 80GB cannot hold, and the smallest grid of
    them that holds each (``launch.dryrun --grid``; PERF.md section 4)."""
    from repro_torch.launch import dryrun
    recs = dryrun.grid_run(LM_CELLS, 2, 2, 85_017_493_504, "cpu",
                           log=lambda _m: None)
    got = {(r["one_card"]["arch"], r["one_card"]["shape"]):
           tuple(r["smallest"]["grid"]) for r in recs if "smallest" in r}
    assert len(got) == 18
    assert got == {
        ("yi-6b", "train_4k"): (16, 2), ("yi-6b", "prefill_32k"): (4, 2),
        ("yi-6b", "decode_32k"): (1, 4),
        ("gemma-7b", "train_4k"): (16, 4),
        ("gemma-7b", "prefill_32k"): (4, 4),
        ("gemma-7b", "decode_32k"): (4, 8),
        ("gemma-7b", "long_500k"): (1, 4),
        ("minicpm-2b", "train_4k"): (16, 2),
        ("minicpm-2b", "prefill_32k"): (4, 2),
        ("minicpm-2b", "decode_32k"): (8, 4),
        ("minicpm-2b", "long_500k"): (1, 4),
        ("olmoe-1b-7b", "train_4k"): (4, 8),
        ("olmoe-1b-7b", "prefill_32k"): (1, 8),
        ("olmoe-1b-7b", "decode_32k"): (1, 8),
        ("moonshot-v1-16b-a3b", "train_4k"): (16, 8),
        ("moonshot-v1-16b-a3b", "prefill_32k"): (2, 8),
        ("moonshot-v1-16b-a3b", "decode_32k"): (4, 8),
        ("moonshot-v1-16b-a3b", "long_500k"): (1, 4)}
    for r in recs:
        if "smallest" in r:
            assert r["smallest"]["fits"] and not r["one_card"]["fits"]
