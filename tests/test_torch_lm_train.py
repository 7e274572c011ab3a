"""The port's LM training (``lm_loss``, its gradients, the AdamW train
step, the launcher) held to the JAX package on the CPU.

Parameters come from the JAX package's ``init_lm_params`` and cross
through ``repro_torch.convert``; tokens are numpy draws from fixed seeds.
Tolerances: the loss and every gradient 1e-5 (abs and rel, the
reference's own for its loss variants, ``tests/test_perf_variants.py``);
the 3-step loss streams rtol 1e-5 (the port's loss-stream tolerance,
``tests/test_dist_stream.py``).  The JAX step is the one of
``tests/test_arch_smoke.py``: ``value_and_grad(lm_loss)`` then
``adamw.apply_updates`` from ``adamw.init_state``.
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.core.models import ParamTree
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import steps
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.optim import adamw

TOL = 1e-5
ARCHS = ("olmoe-1b-7b", "moonshot-v1-16b-a3b", "yi-6b")


def _models(arch, seed=0, **over):
    jcfg = dataclasses.replace(
        jregistry.get_arch(arch).make_smoke_config(), **over)
    tcfg = dataclasses.replace(
        registry.get_arch(arch).make_smoke_config(), **over)
    jparams = jlm.init_lm_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams


def _batch(seed, b, s, vocab=512):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (b, s)), rng.integers(0, vocab, (b, s))


def _flat(tree) -> dict:
    return {".".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_loss_and_grads(tcfg, jparams, toks, tgts):
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    loss = lm.lm_loss(tcfg, steps.lm_tree(params), torch.from_numpy(toks),
                      torch.from_numpy(tgts))
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    return float(loss), dict(zip(names, grads, strict=True))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seq,loss_chunk", [(64, 16), (32, 0), (24, 1024)])
def test_lm_loss_and_gradients_match_jax(arch, seq, loss_chunk):
    """Chunked (S > loss_chunk, 4 chunks), unchunked, and a chunk larger
    than S; the MoE load-balance term in the loss and its gradient."""
    jcfg, tcfg, jparams = _models(arch, loss_chunk=loss_chunk)
    toks, tgts = _batch(seq, 2, seq)
    tgts[0, :3] = [-1, 512, 700]          # outside [0, vocab): masked out
    want, jgrads = jax.value_and_grad(lambda p: jlm.lm_loss(
        jcfg, p, jnp.asarray(toks, jnp.int32),
        jnp.asarray(tgts, jnp.int32)))(jparams)
    got, grads = _port_loss_and_grads(tcfg, jparams, toks, tgts)
    np.testing.assert_allclose(got, float(want), rtol=TOL, atol=TOL)
    want_g = _flat(jgrads)
    assert set(grads) == set(want_g)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_g[name], rtol=TOL,
                                   atol=TOL, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_remat_and_chunking_change_no_number(arch):
    """Per-layer checkpointing and the chunked head are storage schedules:
    the loss and gradients equal the plain forward's."""
    _, tcfg, jparams = _models(arch, seed=1)
    toks, tgts = _batch(1, 2, 64)
    runs = [_port_loss_and_grads(
        dataclasses.replace(tcfg, remat=remat, loss_chunk=chunk), jparams,
        toks, tgts) for remat, chunk in ((False, 0), (True, 0), (True, 16))]
    for loss, grads in runs[1:]:
        np.testing.assert_allclose(loss, runs[0][0], rtol=1e-6)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), runs[0][1][name].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=name)


def test_lm_loss_adds_the_load_balance_term():
    """aux_loss_weight x (summed lb) / L, as the reference weighs it."""
    _, tcfg, jparams = _models("olmoe-1b-7b", seed=2)
    params = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams))
    toks, tgts = (torch.from_numpy(a) for a in _batch(2, 2, 16))
    with torch.no_grad():
        _, lb = lm.forward_hidden(tcfg, params, toks)
        with_aux = lm.lm_loss(tcfg, params, toks, tgts)
        without = lm.lm_loss(dataclasses.replace(tcfg, aux_loss_weight=0.0),
                             params, toks, tgts)
    assert float(lb) > 0
    # the difference of two fp32 losses near 6: a few ulps (4.8e-7) apart
    np.testing.assert_allclose(float(with_aux - without),
                               0.01 * float(lb) / tcfg.num_layers, atol=1e-6)


def _jax_step(jcfg, opt_cfg, toks, tgts):
    t, g = jnp.asarray(toks, jnp.int32), jnp.asarray(tgts, jnp.int32)

    @jax.jit
    def step(params, opt):
        loss, grads = jax.value_and_grad(
            lambda p: jlm.lm_loss(jcfg, p, t, g))(params)
        params, opt = jadamw.apply_updates(opt_cfg, params, grads, opt)
        return params, opt, loss

    return step


@pytest.mark.parametrize("arch", ARCHS)
def test_three_adamw_steps_match_jax(arch):
    """The port's ``lm_train_step`` from the JAX package's parameters and
    AdamW state, three steps beside the JAX step: the loss streams and the
    second moments after them.  (Parameters are not compared element by
    element: Adam's first steps move each by ~lr x sign(g), so an element
    whose gradient is at rounding level may step the other way.)"""
    jcfg, tcfg, jparams = _models(arch, seed=3)
    toks, tgts = _batch(3, 2, 32)
    opt_cfg = jadamw.AdamWConfig(warmup_steps=1)
    jstep = _jax_step(jcfg, opt_cfg, toks, tgts)
    jopt = jadamw.init_state(jparams)
    params, opt = convert.lm_train_state_from_jax(
        jax.tree.map(np.asarray, jparams), jax.tree.map(np.asarray, jopt))
    step = steps.lm_train_step(tcfg, adamw.AdamWConfig(warmup_steps=1))
    t_toks, t_tgts = torch.from_numpy(toks), torch.from_numpy(tgts)
    want, got = [], []
    for _ in range(3):
        jparams, jopt, jl = jstep(jparams, jopt)
        params, opt, loss = step(params, opt, t_toks, t_tgts)
        want.append(float(jl))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=TOL)
    assert got[2] < got[0]                 # lr 3e-4 from step 1 on
    assert int(opt["step"]) == int(jopt["step"]) == 3
    want_v = _flat(jopt["v"])              # ~g^2: 1e-4 x each leaf's max
    for name, v in opt["v"].items():
        np.testing.assert_allclose(
            v.numpy(), want_v[name], rtol=0,
            atol=1e-4 * float(np.abs(want_v[name]).max()), err_msg=name)


def test_train_step_updates_in_place_from_init_state():
    """``lm_train_state`` builds the tree and AdamW state the reference
    test starts from; a step writes the same parameter tensors."""
    cfg = registry.get_arch("olmoe-1b-7b").make_smoke_config()
    params, opt = steps.lm_train_state(torch.Generator().manual_seed(0),
                                       cfg)
    assert isinstance(params, ParamTree)
    names = [n for n, _ in params.named_parameters()]
    assert list(opt["m"]) == names == list(opt["master"])
    assert "layers.ffn.router" in names
    assert all(float(v.abs().max()) == 0 for v in opt["v"].values())
    tree = steps.lm_tree(params)
    ptr = tree["layers"]["ffn"]["wo"].data_ptr()
    before = tree["layers"]["ffn"]["wo"].detach().clone()
    toks, tgts = (torch.from_numpy(a) for a in _batch(4, 2, 16))
    params, opt, loss = steps.lm_train_step(cfg)(params, opt, toks, tgts)
    after = steps.lm_tree(params)["layers"]["ffn"]["wo"]
    assert after.data_ptr() == ptr and not torch.equal(after, before)
    assert math.isfinite(float(loss)) and not loss.requires_grad
    assert int(opt["step"]) == 1


def test_launcher_trains_olmoe(capsys):
    launch_train.main(["--arch", "olmoe-1b-7b", "--device", "cpu",
                       "--steps", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "done"
    losses = [float(ln.split()[-1]) for ln in lines if ln.startswith("step")]
    assert [ln.split()[1] for ln in lines[:-1]] == ["0", "1", "2"]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)


def test_launcher_lm_matches_the_train_step(capsys):
    """The launcher's losses are ``lm_train_step``'s on the reference's
    smoke batch (2 x 128 tokens and targets in {0, 1} from
    ``default_rng(0)``), from ``init_lm_params`` and ``init_state``."""
    launch_train.main(["--arch", "moonshot-v1-16b-a3b", "--device", "cpu",
                       "--steps", "2"])
    out = capsys.readouterr().out.splitlines()
    got = [float(ln.split()[-1]) for ln in out if ln.startswith("step")]
    cfg = registry.get_arch("moonshot-v1-16b-a3b").make_smoke_config()
    rng = np.random.default_rng(0)
    toks, tgts = (torch.as_tensor(rng.integers(0, 2, (2, 128)),
                                  dtype=torch.int32) for _ in range(2))
    params, opt = steps.lm_train_state(torch.Generator().manual_seed(0),
                                       cfg)
    step = steps.lm_train_step(cfg)
    want = []
    for _ in range(2):
        params, opt, loss = step(params, opt, toks, tgts)
        want.append(round(float(loss), 4))
    assert got == want


def test_launcher_refuses_dyngnn_flags_and_ranks(monkeypatch, capsys):
    with pytest.raises(SystemExit, match="--stream configure the dyngnn"):
        launch_train.main(["--arch", "yi-6b", "--device", "cpu", "--stream",
                           "--steps", "1"])
    with pytest.raises(SystemExit, match="--ckpt-dir configure"):
        launch_train.main(["--arch", "yi-6b", "--device", "cpu",
                           "--ckpt-dir", "x", "--steps", "1"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="does not divide the 2 processes"):
        launch_train.main(["--arch", "olmoe-1b-7b", "--device", "cpu",
                           "--data-parallel", "3", "--steps", "1"])
    monkeypatch.delenv("WORLD_SIZE")
    capsys.readouterr()
    launch_train.main(["--arch", "din", "--device", "cpu", "--steps", "2"])
    assert capsys.readouterr().out.splitlines()[-1] == "done"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_train.main(["--arch", "olmoe-1b-7b", "--steps", "1"])


def test_serve_shim_warns_and_serves_the_moe_smoke_config(capsys):
    with pytest.warns(DeprecationWarning, match="deprecated"):
        launch_serve.main(["--arch", "olmoe-1b-7b", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "4", "--tokens",
                           "3", "--requests", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in out] == ["wave 0", "wave 1"]
    assert "family=lm; arch=olmoe-1b-7b; 2 queries" in out[0]
    assert out[0].endswith("6 tokens") and out[1].endswith("12 tokens")
    with pytest.warns(DeprecationWarning):
        launch_serve.main(["--arch", "din", "--device", "cpu", "--batch",
                           "2", "--requests", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out == [out[0]] and "family=recsys; arch=din; 2 queries" in out[0]


def test_nothing_in_the_launch_package_imports_jax():
    root = os.path.join(os.path.dirname(__file__), "..", "src",
                        "repro_torch")
    for name in ("launch/steps.py", "launch/serve.py", "nn/moe.py",
                 "configs/olmoe_1b_7b.py", "configs/moonshot_v1_16b_a3b.py",
                 "nn/embedding.py", "models/din.py", "configs/din.py"):
        with open(os.path.join(root, name)) as f:
            text = f.read()
        assert "import jax" not in text and "from repro." not in text, name
