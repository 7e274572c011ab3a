"""The port's LM serving slice held to the JAX package on the CPU.

Inputs are numpy draws from fixed seeds; parameters come from the JAX
package's ``init_lm_params`` and cross through
``repro_torch.convert.lm_params_from_jax``, so nothing depends on matching
RNGs.  Tolerances: 1e-4 (abs and rel) for every layer and for the smoke
models' logits -- fp32 sums of the same products taken in another order
by XLA and by PyTorch; 2e-3 for the decode == training-forward invariant,
the reference's own (``tests/test_lm.py``).  On the CPU the decode path
reaches the ``flash_decode`` kernel's plain version through its wrapper;
``chip_smoke.py`` holds the CUDA kernel to it on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.nn import attention as jattn
from repro.nn import layers as jlayers
from repro.nn import rope as jrope
from repro.serve import ServeConfig as JConfig
from repro.serve import ServeEngine as JEngine
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.models import lm
from repro_torch.nn import attention as attn
from repro_torch.nn import layers
from repro_torch.nn import rope
from repro_torch.serve import ServeConfig, ServeEngine

TOL = 1e-4
INVARIANT_TOL = 2e-3
DENSE_ARCHS = ("yi-6b", "gemma-7b", "minicpm-2b")
MOE_ARCHS = ("olmoe-1b-7b", "moonshot-v1-16b-a3b")
ARCHS = DENSE_ARCHS + MOE_ARCHS


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().to(torch.float32).numpy()
    np.testing.assert_allclose(got, np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _models(arch, seed=0):
    """(JAX cfg, port cfg, JAX params, port params) of an arch's smoke
    config, the port's parameters converted from the JAX ones."""
    jcfg = jregistry.get_arch(arch).make_smoke_config()
    tcfg = registry.get_arch(arch).make_smoke_config()
    jparams = jlm.init_lm_params(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


# ------------------------------------------------------------- layers ------

@pytest.mark.parametrize("d,theta", [(32, 10000.0), (128, 5_000_000.0),
                                     (24, 10000.0)])
def test_apply_rope_matches_jax(d, theta):
    rng = np.random.default_rng(d)
    x = _normal(rng, 2, 7, 3, d)
    pos = rng.integers(0, 5000, size=(2, 7)).astype(np.int32)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(rope.apply_rope(_t(x), _t(pos), theta), want)
    _close(rope.rope_frequencies(d, theta),
           jrope.rope_frequencies(d, theta))


@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm_matches_jax(plus_one):
    rng = np.random.default_rng(int(plus_one))
    x, w = _normal(rng, 3, 5, 64), _normal(rng, 64)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, plus_one)
    _close(layers.rms_norm(_t(x), _t(w), 1e-6, plus_one), want)


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_glu_ffn_matches_jax(activation):
    rng = np.random.default_rng(3)
    p = {"wi_gate": _normal(rng, 48, 96) / 7, "wi_up": _normal(rng, 48, 96) / 7,
         "wo": _normal(rng, 96, 48) / 10}
    x = _normal(rng, 2, 5, 48)
    want = jlayers.glu_ffn_apply({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), activation)
    got = layers.glu_ffn_apply({k: _t(v) for k, v in p.items()}, _t(x),
                               activation)
    _close(got, want)


def test_mlp_matches_jax():
    rng = np.random.default_rng(8)
    dims = [12, 20, 7]
    jl = [{"w": jnp.asarray(_normal(rng, a, b) / 4),
           "b": jnp.asarray(_normal(rng, b))}
          for a, b in zip(dims[:-1], dims[1:])]
    x = _normal(rng, 5, 12)
    tl = [{k: _t(np.asarray(v)) for k, v in layer.items()} for layer in jl]
    for act, final in (("relu", False), ("gelu", True)):
        want = jlayers.mlp_apply(jl, jnp.asarray(x), act, final)
        _close(layers.mlp_apply(tl, _t(x), act, final), want)
    init = layers.init_mlp(torch.Generator().manual_seed(0), dims)
    assert [tuple(l["w"].shape) for l in init] == [(12, 20), (20, 7)]


def _qkv(seed, b, s, h, kvh, d):
    rng = np.random.default_rng(seed)
    return (_normal(rng, b, s, h, d), _normal(rng, b, s, kvh, d),
            _normal(rng, b, s, kvh, d))


@pytest.mark.parametrize("h,kvh", [(8, 2), (4, 4)])
def test_causal_attention_matches_jax(h, kvh):
    q, k, v = _qkv(h, 2, 33, h, kvh, 16)
    want = jattn.causal_attention(*map(jnp.asarray, (q, k, v)))
    _close(attn.causal_attention(*map(_t, (q, k, v))), want)
    # a query chunk at an offset sees the same key prefix
    want = jattn.causal_attention(*map(jnp.asarray, (q[:, 20:], k, v)),
                                  q_offset=20)
    _close(attn.causal_attention(_t(q[:, 20:]), _t(k), _t(v), q_offset=20),
           want)


@pytest.mark.parametrize("s,chunk", [(256, 64), (96, 32), (100, 32)])
def test_chunked_causal_attention_matches_jax(s, chunk):
    q, k, v = _qkv(s, 2, s, 4, 2, 16)
    want = jattn.chunked_causal_attention(*map(jnp.asarray, (q, k, v)),
                                          q_chunk=chunk)
    got = attn.chunked_causal_attention(*map(_t, (q, k, v)), q_chunk=chunk)
    _close(got, want)
    _close(got, jattn.causal_attention(*map(jnp.asarray, (q, k, v))))


def _attn_params(rng, d_model, h, kvh, d):
    s = float(1.0 / np.sqrt(d_model))
    return {"wq": _normal(rng, d_model, h, d) * s,
            "wk": _normal(rng, d_model, kvh, d) * s,
            "wv": _normal(rng, d_model, kvh, d) * s,
            "wo": _normal(rng, h, d, d_model) * s}


def test_attention_apply_matches_jax():
    rng = np.random.default_rng(5)
    p = _attn_params(rng, 64, 4, 2, 16)
    x = _normal(rng, 2, 12, 64)
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32)
    want = jattn.attention_apply({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), jnp.asarray(pos), 5e6)
    got = attn.attention_apply({k: _t(v) for k, v in p.items()}, _t(x),
                               _t(pos), 5e6)
    _close(got, want)


def test_decode_step_attention_writes_cache_in_place():
    rng = np.random.default_rng(6)
    b, s, h, kvh, d, dm = 3, 20, 4, 2, 16, 64
    p = _attn_params(rng, dm, h, kvh, d)
    x = _normal(rng, b, dm)
    kc, vc = _normal(rng, b, s, kvh, d), _normal(rng, b, s, kvh, d)
    clen = np.array([0, 7, 19], np.int32)
    want, wk, wv = jattn.decode_step_attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(clen), 10000.0)
    k_t, v_t = _t(kc.copy()), _t(vc.copy())
    k_ptr = k_t.data_ptr()
    got = attn.decode_step_attention({k: _t(v) for k, v in p.items()},
                                     _t(x), k_t, v_t, _t(clen), 10000.0)
    _close(got, want)
    assert k_t.data_ptr() == k_ptr          # the same storage, written
    _close(k_t, wk)
    _close(v_t, wv)
    # rows other than cache_len are untouched
    mask = np.ones((b, s), bool)
    mask[np.arange(b), clen] = False
    np.testing.assert_array_equal(k_t.numpy()[mask], kc[mask])


@pytest.mark.parametrize("s,lens", [(700, [0, 1, 700]), (64, [64, 3, 90]),
                                    (513, [512, 513, 0])])
def test_decode_attention_matches_decode_attention_jnp(s, lens):
    """The port's decode attention (the wrapper) against the JAX path it
    replaces: ragged S, cache_len 0, 1, S and above S."""
    rng = np.random.default_rng(s)
    b, hq, kvh, d = len(lens), 8, 2, 32
    q = _normal(rng, b, hq, d)
    k, v = _normal(rng, b, s, kvh, d), _normal(rng, b, s, kvh, d)
    clen = np.array(lens, np.int32)
    want = jattn.decode_attention_jnp(*map(jnp.asarray, (q, k, v, clen)))
    _close(attn.decode_attention(*map(_t, (q, k, v, clen))), want)


# -------------------------------------------------------------- models -----

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copy_the_reference(arch):
    jspec, tspec = jregistry.get_arch(arch), registry.get_arch(arch)
    assert tspec.family == jspec.family == "lm"
    for make in ("make_config", "make_smoke_config"):
        jc, tc = getattr(jspec, make)(), getattr(tspec, make)()
        for f in ("name", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "head_dim", "d_ff", "vocab_size",
                  "activation", "rope_theta", "norm_eps", "rms_plus_one",
                  "embed_scale", "moe_experts", "moe_top_k",
                  "moe_capacity_factor", "aux_loss_weight", "remat",
                  "loss_chunk", "q_chunk", "lr_schedule"):
            assert getattr(tc, f) == getattr(jc, f), (make, f)
        assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name
        assert tc.padded_vocab == jc.padded_vocab
        assert tc.is_moe == jc.is_moe == (arch in MOE_ARCHS)
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_params_has_the_reference_tree(arch):
    jcfg, tcfg, jparams, _ = _models(arch)
    tparams = lm.init_lm_params(torch.Generator().manual_seed(0), tcfg)
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in jflat:
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert node.dtype == torch.float32
    n = sum(x.numel() for x in jax.tree.leaves(tparams))
    assert n == sum(a.size for a in jax.tree.leaves(jparams))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jcfg, tcfg, jparams, tparams = _models(arch)
    toks = np.random.default_rng(1).integers(0, 512, (2, 10))
    want, _ = jlm.forward(jcfg, jparams, jnp.asarray(toks, jnp.int32))
    _close(lm.forward(tcfg, tparams, _t(toks)), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill logits and cache, then teacher-forced decode steps."""
    jcfg, tcfg, jparams, tparams = _models(arch)
    toks = np.random.default_rng(2).integers(0, 512, (2, 12))
    jt = jnp.asarray(toks, jnp.int32)
    jlog, jcache = jlm.prefill(jcfg, jparams, jt[:, :6], max_len=16)
    tlog, tcache = lm.prefill(tcfg, tparams, _t(toks[:, :6]), max_len=16)
    _close(tlog, jlog)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])
    np.testing.assert_array_equal(tcache["len"].numpy(), [6, 6])
    for t in range(6, 12):
        jlog, jcache = jlm.decode_step(jcfg, jparams, jcache, jt[:, t])
        tlog, tcache = lm.decode_step(tcfg, tparams, tcache, _t(toks[:, t]))
        _close(tlog, jlog)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])
    np.testing.assert_array_equal(tcache["len"].numpy(),
                                  np.asarray(jcache["len"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_training_forward(arch):
    """The reference's KV-cache invariant on the port: decode logits equal
    the training forward's, position by position.  An MoE layer drops
    tokens past its capacity, which depends on the tokens routed together
    (B x S in the forward, B in a decode step), so the MoE archs are held
    to it with capacity to spare (nothing dropped on either side)."""
    _, tcfg, _, tparams = _models(arch, seed=3)
    if tcfg.is_moe:
        tcfg = dataclasses.replace(tcfg, moe_capacity_factor=16.0)
    toks = _t(np.random.default_rng(0).integers(0, 512, (2, 12)))
    logits_f = lm.forward(tcfg, tparams, toks)
    plog, cache = lm.prefill(tcfg, tparams, toks[:, :6], max_len=16)
    _close(plog, logits_f[:, 5].numpy(), INVARIANT_TOL)
    for t in range(6, 10):
        lg, cache = lm.decode_step(tcfg, tparams, cache, toks[:, t])
        _close(lg, logits_f[:, t].numpy(), INVARIANT_TOL)


def test_serve_engine_generates_the_jax_engines_tokens():
    sc = dict(arch="yi-6b", batch_sizes=(2,), prompt_len=8, max_tokens=4)
    jcfg = jregistry.get_arch("yi-6b").make_smoke_config()
    jparams = jlm.init_lm_params(jax.random.PRNGKey(11), jcfg)
    want = JEngine(JConfig(**sc), params=jparams).generate()
    tparams = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams))
    eng = ServeEngine(ServeConfig(**sc), params=tparams, device="cpu")
    got = eng.generate()
    assert got.shape == (2, 4) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    r = eng.result()
    assert (r.family, r.tokens_generated, r.queries) == ("lm", 8, 2)
    assert r.metrics["counters"]["serve.tokens_generated"] == 8
    # explicit prompts, a second wave on the same engine
    prompts = np.random.default_rng(4).integers(0, 512, (3, 8))
    want = JEngine(JConfig(**sc), params=jparams).generate(prompts)
    np.testing.assert_array_equal(eng.generate(prompts), np.asarray(want))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_serve_engine_generates_the_jax_engines_tokens(arch):
    sc = dict(arch=arch, batch_sizes=(3,), prompt_len=8, max_tokens=5)
    jcfg = jregistry.get_arch(arch).make_smoke_config()
    jparams = jlm.init_lm_params(jax.random.PRNGKey(12), jcfg)
    want = JEngine(JConfig(**sc), params=jparams).generate()
    tparams = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams))
    eng = ServeEngine(ServeConfig(**sc), params=tparams, device="cpu")
    np.testing.assert_array_equal(eng.generate(), np.asarray(want))
    assert eng.result().tokens_generated == 15


def test_generate_spans_and_family_guards():
    from repro_torch import obs
    tracer = obs.configure(enabled=True)
    try:
        eng = ServeEngine(ServeConfig(arch="minicpm-2b", batch_sizes=(2,),
                                      prompt_len=4, max_tokens=5),
                          device="cpu")
        toks = eng.generate()
    finally:
        obs.configure(enabled=False)
    names = [sp.name for sp in tracer.spans()]
    assert names.count("serve.prefill") == 1
    assert names.count("serve.decode") == 4
    assert "serve.generate" in names
    assert toks.shape == (2, 5) and ((toks >= 0) & (toks < 512)).all()
    with pytest.raises(ValueError, match="dyngnn family"):
        eng.query_nodes([0])
    with pytest.raises(ValueError, match="prompt_len"):
        ServeConfig(arch="yi-6b", prompt_len=0).validate()


# ------------------------------------------------------------ convert -----

def test_bf16_params_cross_bit_exactly():
    jcfg = jregistry.get_arch("yi-6b").make_smoke_config()
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    jparams = jax.tree.map(np.asarray,
                           jlm.init_lm_params(jax.random.PRNGKey(2), jcfg))
    tparams = convert.lm_params_from_jax(jparams)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        node = tparams
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.bfloat16
        np.testing.assert_array_equal(node.view(torch.int16).numpy(),
                                      leaf.view(np.int16))
        back = node.view(torch.int16).numpy().view(jnp.bfloat16)
        np.testing.assert_array_equal(back.view(np.int16),
                                      leaf.view(np.int16))
    # the dyngnn converters share the same leaf conversion
    arr = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    [t] = convert.carries_from_jax([arr])
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  arr.view(np.int16))


def test_moe_params_cross_with_an_fp32_router():
    """An MoE tree in bf16: the experts cross bit for bit in bf16, the
    router (fp32 in the reference) in fp32."""
    jcfg = dataclasses.replace(
        jregistry.get_arch("olmoe-1b-7b").make_smoke_config(),
        dtype=jnp.bfloat16)
    jparams = jax.tree.map(np.asarray,
                           jlm.init_lm_params(jax.random.PRNGKey(5), jcfg))
    tparams = convert.lm_params_from_jax(jparams)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        node = tparams
        for key in path:
            node = node[key.key]
        name = jax.tree_util.keystr(path)
        if "router" in name:
            assert node.dtype == torch.float32 and leaf.dtype == np.float32
            np.testing.assert_array_equal(node.numpy(), leaf)
        else:
            assert node.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(node.view(torch.int16).numpy(),
                                          leaf.view(np.int16))


# ------------------------------------------------------------ refusals ----

@pytest.mark.parametrize("arch", ["gatedgcn", "schnet"])
def test_unported_archs_raise(arch):
    """The static GNNs are ported for training but have no serving path,
    in the reference either: serving one raises the reference's
    ``ValueError``.  (``din`` serves through ``score``:
    ``tests/test_torch_recsys_serve.py``.)"""
    assert registry.get_arch(arch).family == "gnn"
    with pytest.raises(ValueError, match="static-graph gnn"):
        ServeEngine(ServeConfig(arch=arch), device="cpu")


def test_moe_config_raises():
    """An MoE LMConfig builds the MoE tree (stacked router, experts) and is
    served; one whose top-k exceeds its experts raises in the router."""
    cfg = lm.LMConfig(num_layers=3, d_model=32, num_heads=2, num_kv_heads=2,
                      head_dim=16, d_ff=24, vocab_size=256, moe_experts=4,
                      moe_top_k=2, dtype=torch.bfloat16)
    params = lm.init_lm_params(torch.Generator().manual_seed(0), cfg)
    ffn = params["layers"]["ffn"]
    assert {k: tuple(v.shape) for k, v in ffn.items()} == {
        "router": (3, 32, 4), "wi_gate": (3, 4, 32, 24),
        "wi_up": (3, 4, 32, 24), "wo": (3, 4, 24, 32)}
    assert ffn["router"].dtype == torch.float32
    assert ffn["wo"].dtype == torch.bfloat16
    n = sum(x.numel() for x in jax.tree.leaves(params))
    assert n == cfg.param_count()
    eng = ServeEngine(ServeConfig(model=cfg, batch_sizes=(2,), prompt_len=4,
                                  max_tokens=3), device="cpu")
    assert eng.generate().shape == (2, 3)
    bad = dataclasses.replace(cfg, moe_top_k=5, dtype=torch.float32)
    with pytest.raises(RuntimeError):
        lm.forward(bad, lm.init_lm_params(torch.Generator(), bad),
                   torch.zeros((1, 4), dtype=torch.long))


def test_flash_decode_wrapper_runs_the_plain_version_on_the_cpu(monkeypatch):
    """The decode path reaches the kernel's plain version through the
    wrapper (on the card the same call launches the kernel)."""
    calls = []
    real = fd_ref.flash_decode_ref

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(fd_ops, "flash_decode_ref", spy)
    eng = ServeEngine(ServeConfig(arch="yi-6b", batch_sizes=(2,),
                                  prompt_len=4, max_tokens=3), device="cpu")
    eng.generate()
    # 2 decode steps x 2 layers, each on (B, Hq, D)
    assert calls == [(2, 4, 32)] * 4
    assert fd_ops.KERNEL.launches == 0
