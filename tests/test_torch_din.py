"""The port's DIN (``models/din``, ``launch/steps``' recsys steps) held to
the JAX package on the CPU, at the smoke config.

The same parameters (the reference's init through
``convert.din_params_from_jax``) and the same batches
(``launch.steps.din_batch_arrays``: ragged histories, seeded) go through
both: ``target_attention``, ``forward`` and ``ctr_loss`` at 1e-5, every
gradient of ``ctr_loss`` within 1e-5 x its leaf's max |value| against
``jax.grad``; ``score_candidates`` unchunked and at chunks that do not
divide N, against the reference's at 1e-5; and three ``din_train_step``
calls beside the reference's own ``_din_cell`` train step
(``build_cell(..., smoke=True, shape_override={"batch": 16})`` on a one-
device host mesh), losses at rtol 1e-5 and parameters at 1e-5 x each
leaf's max.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.models import din as jdin
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.core.models import ParamTree
from repro_torch.launch import steps
from repro_torch.models import din

TOL = 1e-5
CFG = registry.get_arch("din").make_smoke_config()
# through the registry: importing one of its config modules alone would
# leave the reference's registry holding that arch only
JSPEC = jregistry.get_arch("din")
JCFG = JSPEC.make_smoke_config()


def _shape(name: str, **dims):
    base = registry.get_arch("din").shapes[name]
    return dataclasses.replace(base, dims={**base.dims, **dims})


def _jparams(seed: int = 0):
    return jdin.init_params(jax.random.PRNGKey(seed), JCFG)


def _port(jparams) -> dict:
    return convert.din_params_from_jax(jax.tree.map(np.asarray, jparams))


def _jbatch(arrays: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in arrays.items()
            if k not in ("labels", "cand_items", "cand_cates")}


def _tbatch(arrays: dict) -> dict:
    return din.batch_to({k: v for k, v in arrays.items()
                         if k not in ("labels", "cand_items", "cand_cates")})


def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def test_registry_has_exactly_the_references_archs_and_shapes():
    """Every arch id of the reference, with its family and its shapes'
    kinds and dims: nothing is left unported or hidden."""
    def table(archs):
        return {k: (v.family, {n: (s.kind, s.dims)
                               for n, s in v.shapes.items()})
                for k, v in archs.items()}

    want = table(jregistry.all_archs())
    assert table(registry.all_archs()) == want
    # the ten assigned archs' 40 (arch x shape) cells
    assert sum(len(shapes) for fam, shapes in want.values()
               if fam != "dyngnn") == 40


def test_configs_equal_the_reference():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)
    assert dataclasses.asdict(registry.get_arch("din").make_config()) == \
        dataclasses.asdict(JSPEC.make_config())


def test_params_from_jax_and_init_keep_the_tree():
    jp = _jparams()
    tp = _port(jp)
    want = _flat(jax.tree.map(np.asarray, jp))
    got = _flat(tp)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.dtype == want[k].dtype and v.shape == want[k].shape, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    fresh = _flat(din.init_params(torch.Generator().manual_seed(0), CFG))
    assert {k: v.shape for k, v in fresh.items()} == \
        {k: v.shape for k, v in want.items()}
    assert float(np.abs(fresh["mlp.0.b"]).max()) == 0.0


def test_target_attention_and_forward():
    jp = _jparams()
    tp = _port(jp)
    arrays = steps.din_batch_arrays(CFG, _shape("serve_p99", batch=12),
                                    seed=3)
    assert 0 < arrays["hist_mask"].mean() < 1     # ragged histories
    jb, tb = _jbatch(arrays), _tbatch(arrays)
    hist = jdin._pair_embed(jp, jb["hist_items"], jb["hist_cates"])
    target = jdin._pair_embed(jp, jb["target_item"], jb["target_cate"])
    want = jdin.target_attention(jp, hist, jb["hist_mask"], target)
    got = din.target_attention(
        tp, din._pair_embed(tp, tb["hist_items"], tb["hist_cates"]),
        tb["hist_mask"], din._pair_embed(tp, tb["target_item"],
                                         tb["target_cate"]))
    _close(got, want)
    logits = din.forward(tp, tb)
    assert logits.shape == (12, CFG.num_classes)
    _close(logits, jdin.forward(jp, jb))
    # a ParamTree serves the same logits as the nested dict
    assert torch.equal(din.forward(ParamTree(tp), tb).detach(), logits)
    # the serve step is the forward without autograd
    served = steps.din_serve_step(ParamTree(tp), tb)
    assert not served.requires_grad and torch.equal(served, logits)


def test_ctr_loss_and_every_gradient():
    jp = _jparams(1)
    tp = ParamTree(_port(jp))
    arrays = steps.din_batch_arrays(CFG, _shape("train_batch", batch=16),
                                    seed=4)
    labels = arrays["labels"]
    assert set(np.unique(labels)) <= {0, 1}
    jloss, jgrads = jax.jit(jax.value_and_grad(jdin.ctr_loss))(
        jp, _jbatch(arrays), jnp.asarray(labels))
    loss, grads = steps.din_loss_and_grads(tp, _tbatch(arrays),
                                           torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    want = _flat(jax.tree.map(np.asarray, jgrads))
    names = [n for n, _ in tp.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads, strict=True):
        w = want[name]
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TOL * float(np.abs(w).max()),
                                   err_msg=name)
    # the tables' gradients are dense, nonzero only on the rows looked up
    rows = np.unique(np.concatenate([arrays["hist_items"].ravel(),
                                     arrays["target_item"]]))
    g_item = grads[names.index("item_table")].numpy()
    assert np.abs(np.delete(g_item, rows, axis=0)).max() == 0.0


@pytest.mark.parametrize("chunk", [None, 8, 16, 64])
def test_score_candidates_chunked_and_unchunked(chunk):
    jp = _jparams(2)
    tp = _port(jp)
    arrays = steps.din_batch_arrays(
        CFG, _shape("retrieval_cand", n_candidates=37), seed=5)
    assert arrays["hist_items"].shape == (1, CFG.seq_len)
    jb, tb = _jbatch(arrays), _tbatch(arrays)
    want = jax.jit(jdin.score_candidates)(
        jp, jb, jnp.asarray(arrays["cand_items"]),
        jnp.asarray(arrays["cand_cates"]))
    items = torch.from_numpy(arrays["cand_items"])
    cates = torch.from_numpy(arrays["cand_cates"])
    got = steps.din_retrieval_step(tp, tb, items, cates, chunk=chunk)
    assert got.shape == (37,) and not got.requires_grad
    _close(got, want)
    # each chunk's scores are those rows of the unchunked call
    _close(got, din.score_candidates(tp, tb, items, cates), 1e-7)


def test_score_candidates_refuses_a_bad_chunk():
    arrays = steps.din_batch_arrays(
        CFG, _shape("retrieval_cand", n_candidates=4), seed=0)
    tp = din.init_params(torch.Generator().manual_seed(0), CFG)
    with pytest.raises(ValueError, match="chunk"):
        din.score_candidates(tp, _tbatch(arrays),
                             torch.from_numpy(arrays["cand_items"]),
                             torch.from_numpy(arrays["cand_cates"]), chunk=0)


def test_din_batch_draws_in_range_and_is_seeded():
    for name in ("train_batch", "serve_p99", "retrieval_cand"):
        shape = _shape(name, batch=1 if name == "retrieval_cand" else 8,
                       **({"n_candidates": 50}
                          if name == "retrieval_cand" else {}))
        a = steps.din_batch_arrays(CFG, shape, seed=9)
        b = steps.din_batch_arrays(CFG, shape, seed=9)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        assert a["hist_items"].max() < CFG.item_vocab
        assert a["hist_cates"].max() < CFG.cate_vocab
        assert a["user_id"].max() < CFG.user_vocab
        assert (a["hist_mask"][:, 0] == 1).all()   # at least one item each
    t = steps.din_batch(CFG, _shape("train_batch", batch=4))
    assert t["hist_items"].dtype == torch.int32
    assert t["hist_mask"].dtype == torch.float32


def test_three_train_steps_match_the_reference_cell():
    mesh = make_host_mesh(1, 1)
    cell = jsteps.build_cell("din", "train_batch", mesh, smoke=True,
                             shape_override={"batch": 16})
    arrays = steps.din_batch_arrays(CFG, _shape("train_batch", batch=16),
                                    seed=6)
    jp = _jparams(3)
    jopt = jadamw.init_state(jp)
    params = ParamTree(_port(jp))
    opt = convert.opt_state_from_jax(jax.tree.map(np.asarray, jopt))
    step = steps.din_train_step()
    tb, tl = _tbatch(arrays), torch.from_numpy(arrays["labels"])
    jb, jl = _jbatch(arrays), jnp.asarray(arrays["labels"])
    want, got = [], []
    with mesh:
        jstep = jax.jit(cell.step, in_shardings=cell.in_shardings,
                        out_shardings=cell.out_shardings)
        for _ in range(3):
            jp, jopt, jloss = jstep(jp, jopt, jb, jl)
            params, opt, loss = step(params, opt, tb, tl)
            want.append(float(jloss))
            got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=TOL)
    assert int(opt["step"]) == int(jopt["step"]) == 3
    want_p = _flat(jax.tree.map(np.asarray, jp))
    for name, p in params.named_parameters():
        w = want_p[name]
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=TOL * float(np.abs(w).max()),
                                   err_msg=name)
