"""The port's single-device training path held to the JAX package.

Sizes are ``tests/test_run_api.py``'s: N = 48, T = 16, window 3, nb 2.
Inputs come from numpy seeds (the synthetic traces, copied byte-identical)
and parameters cross over with ``convert.params_from_jax``.  On CPU tensors
the kernel wrappers run their plain versions, and the autograd functions
(``SegmentSpmmFn``, ``MProductWithPrefixFn``) route the backward through the same
wrappers the card uses, so:

* the two backwards equal the dense transposes (``A_tilde^T dY``,
  ``M^T dY``) at 1e-6, the prefix carry's gradient included;
* ``node_loss`` / ``blocked_node_loss`` gradients equal ``jax.grad`` of the
  JAX functions at atol 1e-5 (``tests/test_core_paper.py``'s tolerance),
  and blocked gradients equal unblocked ones at 1e-5;
* ``adamw.apply_updates`` equals the JAX update at 1e-6 for every schedule
  with clipping active;
* a 12-step eager ``Engine`` loss stream equals the JAX Engine's at rtol
  1e-5 from the same parameters, which end within 1e-4 of each other,
  and ``Engine.evaluate`` gives the JAX Engine's accuracy, its link
  logits within 1e-5 of the JAX package's from the same parameters;
* the copied host numpy (``pad``, ``smoothing``, the synthetic datasets,
  the padded batch) is byte-identical; the batch's Laplacian weights come
  from torch's ``rsqrt`` and agree with ``jnp``'s to 1e-6 (a last-ulp
  difference between the two libraries).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import checkpoint as jckpt
from repro.core import dtdg as jdtdg
from repro.core import models as jm
from repro.core import smoothing as jsmooth
from repro.core import temporal as jtemporal
from repro.data import dyngnn as jdata
from repro.graph import pad as jpad
from repro.optim import adamw as jadamw
from repro.run import Engine as JEngine
from repro.run import ExecutionPlan as JPlan
from repro.run import RunConfig as JRunConfig
from repro.run import SyntheticTrace as JTrace
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.core import checkpoint as ckpt
from repro_torch.core import dtdg, gcn, smoothing, temporal
from repro_torch.core import models as tm
from repro_torch.data import dyngnn as data
from repro_torch.graph import pad
from repro_torch.kernels.mproduct import ops as mp_ops
from repro_torch.kernels.mproduct import ref as mp_ref
from repro_torch.kernels.segment_spmm import ops as spmm_ops
from repro_torch.launch import train as launch_train
from repro_torch.optim import adamw
from repro_torch.run import (CheckpointSpec, Engine, ExecutionPlan,
                             InMemoryDTDG, RunConfig, SyntheticTrace)
from repro_torch.train import trainer

N, T, W, NB = 48, 16, 3, 2
GRAD_TOL = 1e-5
MODELS = ["tmgcn", "cdgcn", "evolvegcn"]
SMOOTH = {"tmgcn": "mproduct", "evolvegcn": "edgelife", "cdgcn": "none"}


def _silent(_msg):
    return None


def _jcfg(model, nb=NB):
    return jm.DynGNNConfig(model=model, num_nodes=N, num_steps=T, window=W,
                           checkpoint_blocks=nb)


def _tcfg(model, nb=NB):
    return tm.DynGNNConfig(model=model, num_nodes=N, num_steps=T, window=W,
                           checkpoint_blocks=nb)


def _trace(cls, model):
    return cls(num_nodes=N, num_steps=T, density=2.0, churn=0.1,
               smoothing_mode=SMOOTH[model], window=W)


def _named(tree) -> dict:
    """A JAX tree -> {``layers.0.gcn.w``: numpy}, the port's names."""
    return {jax.tree_util.keystr(k, simple=True, separator="."):
            np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _params(model, seed=1):
    params = jm.init_params(jax.random.PRNGKey(seed), _jcfg(model))
    return params, convert.params_from_jax(jax.tree.map(np.asarray, params))


def _batches(model, seed=0):
    """The same synthetic trace as a JAX batch and a port batch (CPU)."""
    jds = jdata.synthetic_dataset(N, T, density=2.0,
                                  smoothing_mode=SMOOTH[model], window=W,
                                  seed=seed)
    ds = data.synthetic_dataset(N, T, density=2.0,
                                smoothing_mode=SMOOTH[model], window=W,
                                seed=seed)
    jb = jdtdg.build_batch(jds.snapshots, jds.frames, N, values=jds.values)
    tb = dtdg.build_batch(ds.snapshots, ds.frames, N, values=ds.values,
                          device="cpu")
    return jb, tb, ds.labels


def _grads(loss, params) -> dict:
    names = [k for k, _ in params.named_parameters()]
    return dict(zip(names, (g.numpy() for g in torch.autograd.grad(
        loss, list(params.parameters()))), strict=True))


def _assert_trees_close(got: dict, want: dict, atol, rtol=0.0):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol,
                                   err_msg=k)


# ------------------------------------------------- backward kernels ---------

@pytest.mark.parametrize("f", [2, 6])
def test_segment_spmm_fn_backward_is_the_transposed_aggregate(f):
    rng = np.random.default_rng(f)
    e = 200
    edges = rng.integers(0, N, size=(e, 2)).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    w[rng.random(e) < 0.2] = 0.0            # pad lanes: zero weight
    dense = np.zeros((N, N), np.float64)
    np.add.at(dense, (edges[:, 1], edges[:, 0]), w)     # A[dst, src] += w
    x = torch.from_numpy(rng.normal(size=(N, f)).astype(np.float32))
    dy = rng.normal(size=(N, f)).astype(np.float32)
    te, tw = torch.from_numpy(edges), torch.from_numpy(w)
    csr, csr_t = spmm_ops.build_csr_pair(te, tw, N)
    x.requires_grad_(True)
    y = spmm_ops.SegmentSpmmFn.apply(x, csr, csr_t)
    (dx,) = torch.autograd.grad(y, x, torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(),
                               dense @ x.detach().numpy(), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(dx.numpy(), dense.T @ dy, atol=1e-6,
                               rtol=1e-6)


def test_segment_spmm_fn_launches_no_backward_for_an_input_without_grad(
        monkeypatch):
    """Layer 1's input (the frames) needs no gradient: only the forward
    runs; a differentiated x without its transposed CSR is refused."""
    calls = []
    plain = spmm_ops.segment_spmm_csr_ref

    def counted(x, row_ptr, col, w):
        calls.append(x.shape)
        return plain(x, row_ptr, col, w)

    _, tb, _ = _batches("tmgcn")
    pairs = tb.csr_pairs()
    monkeypatch.setattr(spmm_ops, "segment_spmm_csr_ref", counted)
    p = torch.ones((N, 2), requires_grad=True)
    y = spmm_ops.SegmentSpmmFn.apply(tb.frames[0], *pairs[0]) * p
    y.sum().backward()
    assert len(calls) == 1
    with pytest.raises(ValueError, match="transposed CSR"):
        gcn.spatial_aggregate(p, tb.edges[0], tb.edge_weights[0], N,
                              pairs[0][0])


def _band_matrix(t, w, t_offset):
    """Dense M of ``banded_ttm`` (rows of the slice, global offset)."""
    m = np.zeros((t, t), np.float64)
    for r in range(t):
        g = r + t_offset + 1
        for k in range(max(0, r - w + 1, -t_offset), r + 1):
            m[r, k] = 1.0 / min(w, g)
    return m


@pytest.mark.parametrize("t,w,t_offset", [(12, 5, -4), (12, 5, 4),
                                          (8, 3, 0), (6, 5, -2), (5, 5, 9),
                                          (4, 6, -7)])
def test_banded_ttm_fn_backward_is_the_transposed_band(t, w, t_offset):
    rng = np.random.default_rng(t * 10 + w)
    x = torch.from_numpy(rng.normal(size=(t, 7)).astype(np.float32))
    dy = rng.normal(size=(t, 7)).astype(np.float32)
    m = _band_matrix(t, w, t_offset)
    x.requires_grad_(True)
    y = mp_ops.m_product(x, w, t_offset)
    (dx,) = torch.autograd.grad(y, x, torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), m @ x.detach().numpy(),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(dx.numpy(), m.T @ dy, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        mp_ref.banded_ttm_t_ref(torch.from_numpy(dy), w, t_offset).numpy(),
        m.T @ dy, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("t_offset", [0, 6])
def test_m_product_gradient_reaches_the_prefix_carry(t_offset):
    """Under checkpointing the prefix is the previous block's output: its
    gradient is the first w - 1 rows of M^T dY over [prefix, slice]."""
    rng = np.random.default_rng(t_offset)
    w, t, n, f = 4, 6, 5, 3
    prefix = torch.from_numpy(rng.normal(size=(w - 1, n, f)).astype(
        np.float32)).requires_grad_(True)
    x = torch.from_numpy(rng.normal(size=(t, n, f)).astype(
        np.float32)).requires_grad_(True)
    dy = rng.normal(size=(t, n, f)).astype(np.float32)
    y = temporal.m_product_with_prefix(x, prefix, w, t_offset)
    gp, gx = torch.autograd.grad(y, (prefix, x), torch.from_numpy(dy))
    m = _band_matrix(t + w - 1, w, t_offset - (w - 1))[w - 1:]
    full = (m.T @ dy.reshape(t, -1)).reshape(t + w - 1, n, f)
    np.testing.assert_allclose(gp.numpy(), full[:w - 1], atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(gx.numpy(), full[w - 1:], atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("w", range(1, 9))
def test_banded_ttm_t_kept_rows_is_the_dense_transpose(w):
    """The plain transposed band over the kept rows, M[lead:]^T dZ, against
    the dense band for T_s 1-12 (w > T_s included), t_offset -7 to +9,
    with and without the lead rows written."""
    rng = np.random.default_rng(w)
    for t_s in range(1, 13):
        dz = rng.normal(size=(t_s, 3)).astype(np.float32)
        for t_offset in range(-7, 10):
            for lead in sorted({0, w - 1}):
                m = _band_matrix(lead + t_s, w, t_offset)[lead:]
                want = m.T @ dz
                got = mp_ref.banded_ttm_t_ref(torch.from_numpy(dz), w,
                                              t_offset, lead)
                np.testing.assert_allclose(got.numpy(), want, atol=1e-6,
                                           rtol=1e-6)
                part = mp_ref.banded_ttm_t_ref(torch.from_numpy(dz), w,
                                               t_offset, lead,
                                               write_lead=False)
                assert part.shape == (t_s, 3)
                np.testing.assert_allclose(part.numpy(), want[lead:],
                                           atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("t_s,t_offset", [(6, 0), (6, 2), (6, 4), (6, 9),
                                          (2, 9), (1, 5), (3, 12)])
def test_m_product_with_prefix_gradients_match_jax(t_s, t_offset):
    """Gradients into the prefix and the slice against ``jax.grad`` of the
    JAX package's ``m_product_with_prefix``.  Prefix rows before global
    step 1 are zeros on the path (the zero initial carry); the JAX
    cumulative-sum form still sends them a gradient, which nothing reads,
    where the band sends none: those rows are held to zero instead."""
    w, n, f = 5, 4, 3
    rng = np.random.default_rng(100 + t_s * 13 + t_offset)
    prefix = rng.normal(size=(w - 1, n, f)).astype(np.float32)
    early = max(0, w - 1 - t_offset)      # prefix rows before step 1
    prefix[:early] = 0.0
    x = rng.normal(size=(t_s, n, f)).astype(np.float32)
    dz = rng.normal(size=(t_s, n, f)).astype(np.float32)

    def jloss(xv, pv):
        return jnp.sum(jtemporal.m_product_with_prefix(xv, pv, w, t_offset)
                       * dz)

    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                jnp.asarray(prefix))
    tp = torch.from_numpy(prefix).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    z = temporal.m_product_with_prefix(tx, tp, w, t_offset)
    np.testing.assert_allclose(
        z.detach().numpy(),
        np.asarray(jtemporal.m_product_with_prefix(
            jnp.asarray(x), jnp.asarray(prefix), w, t_offset)),
        atol=GRAD_TOL)
    gp, gx = torch.autograd.grad(z, (tp, tx), torch.from_numpy(dz))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), atol=GRAD_TOL)
    np.testing.assert_allclose(gp[early:].numpy(), np.asarray(jgp)[early:],
                               atol=GRAD_TOL)
    assert not gp[:early].any()


@pytest.mark.parametrize("prefix_grad", [True, False])
def test_m_product_backward_hands_the_band_only_the_kept_rows(
        monkeypatch, prefix_grad):
    """One transposed-band call per M-product backward, on the slice's
    (T_s, NF) gradient: no zero-filled (T_s + w - 1, NF) gradient is
    made; the lead rows are written only when the prefix needs them."""
    calls = []
    plain = mp_ops.banded_ttm_t_ref

    def spy(dz, window, t_offset, lead, write_lead):
        calls.append((tuple(dz.shape), lead, write_lead))
        return plain(dz, window, t_offset, lead, write_lead)

    monkeypatch.setattr(mp_ops, "banded_ttm_t_ref", spy)
    w, t_s, n, f = 5, 8, 6, 3
    rng = np.random.default_rng(5)
    prefix = torch.from_numpy(rng.normal(size=(w - 1, n, f)).astype(
        np.float32)).requires_grad_(prefix_grad)
    x = torch.from_numpy(rng.normal(size=(t_s, n, f)).astype(
        np.float32)).requires_grad_(True)
    z = temporal.m_product_with_prefix(x, prefix, w, 4)
    z.backward(torch.ones_like(z))
    assert calls == [((t_s, n * f), w - 1, prefix_grad)]
    assert x.grad.shape == x.shape
    assert (prefix.grad is not None) == prefix_grad


@pytest.mark.parametrize("lead,t_offset", [(4, -4), (4, 4), (0, 0)])
def test_m_product_forward_hands_the_band_its_inputs_uncopied(
        monkeypatch, lead, t_offset):
    """One band call per M-product forward, on the prefix's (lead, NF) and
    the slice's (T_s, NF) rows as they lie (the same storage, no
    ``torch.cat`` anywhere), returning only the slice's (T_s, NF) rows."""
    calls, cats = [], []
    plain, cat = mp_ops.banded_ttm_ref, torch.cat

    def spy(prefix, x, window, off):
        out = plain(prefix, x, window, off)
        calls.append((tuple(prefix.shape), tuple(x.shape), tuple(out.shape),
                      prefix.data_ptr(), x.data_ptr(), off))
        return out

    def no_cat(*args, **kwargs):
        cats.append(len(args[0]))
        return cat(*args, **kwargs)

    monkeypatch.setattr(mp_ops, "banded_ttm_ref", spy)
    monkeypatch.setattr(torch, "cat", no_cat)
    w, t_s, n, f = 5, 8, 6, 3
    rng = np.random.default_rng(7)
    prefix = torch.from_numpy(rng.normal(size=(lead, n, f)).astype(
        np.float32))
    x = torch.from_numpy(rng.normal(size=(t_s, n, f)).astype(np.float32))
    z = mp_ops.MProductWithPrefixFn.apply(prefix, x, w, t_offset + lead)
    assert cats == []
    assert calls == [((lead, n * f), (t_s, n * f), (t_s, n * f),
                      prefix.data_ptr(), x.data_ptr(), t_offset)]
    assert z.shape == x.shape


@pytest.mark.parametrize("t_s", [1, 2, 3, 4, 5, 8])
def test_new_prefix_matches_the_jax_carry(t_s):
    """TM-GCN's temporal stage: the output and the next block's (w-1)-frame
    prefix equal the JAX package's for T_s below and above w - 1; at
    T_s >= w - 1 the prefix is a copy of y's last rows, sharing no
    storage with y."""
    w, n, f, t_offset = 5, 4, 3, 9
    rng = np.random.default_rng(t_s)
    y = rng.normal(size=(t_s, n, f)).astype(np.float32)
    carry = rng.normal(size=(w - 1, n, f)).astype(np.float32)
    jcfg = jm.DynGNNConfig(model="tmgcn", num_nodes=n, window=w)
    jz, jcarry = jm.temporal_stage(jcfg, {}, 0, jnp.asarray(y),
                                   jnp.asarray(carry), t_offset)
    ty = torch.from_numpy(y)
    z, new = tm.temporal_stage(tm.DynGNNConfig(model="tmgcn", num_nodes=n,
                                               window=w), {}, ty,
                               torch.from_numpy(carry), t_offset)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=GRAD_TOL)
    np.testing.assert_array_equal(new.numpy(), np.asarray(jcarry))
    if t_s >= w - 1:
        assert new.untyped_storage().data_ptr() != \
            ty.untyped_storage().data_ptr()


def test_banded_ttm_t_kernel_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mp_ops.KERNEL_T.load()
    with pytest.raises(ValueError, match="unsupported device"):
        mp_ops.banded_ttm_t(torch.zeros((3, 4), device="meta"), 2)
    with pytest.raises(ValueError, match="lead must be >= 0"):
        mp_ops.banded_ttm_t(torch.zeros((3, 4)), 2, 0, lead=-1)


# ------------------------------------------------ gradients vs JAX ----------

@pytest.mark.parametrize("model", MODELS)
def test_node_loss_gradients_match_jax(model):
    params, tparams = _params(model)
    jb, tb, labels = _batches(model)
    jlab = jnp.asarray(labels)
    jloss, jgrad = jax.value_and_grad(
        lambda p: jm.node_loss(_jcfg(model), p, jb, jlab))(params)
    loss = tm.node_loss(_tcfg(model), tparams, tb, torch.from_numpy(labels))
    np.testing.assert_allclose(loss.item(), float(jloss), atol=GRAD_TOL)
    _assert_trees_close(_grads(loss, tparams), _named(jgrad), GRAD_TOL)


@pytest.mark.parametrize("model", MODELS)
def test_blocked_node_loss_gradients_match_jax(model):
    params, tparams = _params(model, seed=2)
    jb, tb, labels = _batches(model, seed=3)
    jlab = jnp.asarray(labels)
    jloss, jgrad = jax.value_and_grad(
        lambda p: jckpt.blocked_node_loss(_jcfg(model), p, jb, jlab))(params)
    loss = ckpt.blocked_node_loss(_tcfg(model), tparams, tb,
                                  torch.from_numpy(labels))
    np.testing.assert_allclose(loss.item(), float(jloss), atol=GRAD_TOL)
    _assert_trees_close(_grads(loss, tparams), _named(jgrad), GRAD_TOL)


@pytest.mark.parametrize("nb", [2, 4])
@pytest.mark.parametrize("model", MODELS)
def test_blocked_gradients_equal_unblocked(model, nb):
    cfg = _tcfg(model, nb)
    tparams = tm.init_params(torch.Generator().manual_seed(4), cfg)
    _, tb, labels = _batches(model, seed=5)
    lab = torch.from_numpy(labels)
    z = tm.forward(cfg, tparams, tb)
    zb = ckpt.blocked_forward(cfg, tparams, tb, nb=nb)
    np.testing.assert_allclose(zb.detach().numpy(), z.detach().numpy(),
                               atol=GRAD_TOL)
    _assert_trees_close(
        _grads(ckpt.blocked_node_loss(cfg, tparams, tb, lab, nb=nb),
               tparams),
        _grads(tm.node_loss(cfg, tparams, tb, lab), tparams), GRAD_TOL)


def test_train_step_launch_counts_per_step(monkeypatch):
    """What ``chip_smoke.py`` asserts on the card, counted here on the plain
    versions the same wrappers reach: per step, TM-GCN with L layers over
    T snapshots in nb blocks aggregates L T times forward, L T again in
    the recompute and T times backward (layer 1's input needs none); the
    M-product runs L nb times forward, nb times in the recompute (early
    stop: the last layer's needs no saved tensor) and L nb times
    backward, each on a block's T / nb kept rows; the CSR pairs are built
    once per run (2 T)."""
    calls = {"spmm": 0, "ttm": 0, "ttm_t": 0}
    ttm_t_rows = set()

    def counted(key, fn):
        def call(*a):
            calls[key] += 1
            if key == "ttm_t":
                ttm_t_rows.add(a[0].shape[0])
            return fn(*a)
        return call

    for key, mod, name in (("spmm", spmm_ops, "segment_spmm_csr_ref"),
                           ("ttm", mp_ops, "banded_ttm_ref"),
                           ("ttm_t", mp_ops, "banded_ttm_t_ref")):
        monkeypatch.setattr(mod, name, counted(key, getattr(mod, name)))
    monkeypatch.setattr(spmm_ops, "csr_builds", 0)
    cfg = _tcfg("tmgcn", nb=4)
    ds = _trace(SyntheticTrace, "tmgcn").build()
    pipe = data.DTDGPipeline(ds, nb=4, device="cpu")
    params = tm.init_params(torch.Generator().manual_seed(0), cfg)
    step = trainer.make_single_device_train_step(
        cfg, adamw.AdamWConfig(total_steps=3))
    opt = adamw.init_state(params)
    lab = torch.from_numpy(ds.labels)
    layers = cfg.num_layers
    for k in range(1, 4):
        params, opt, _ = step(params, opt, pipe.batch, lab)
        assert calls == {"spmm": k * (2 * layers * T + T),
                         "ttm": k * (layers * 4 + 4),
                         "ttm_t": k * layers * 4}, k
        assert spmm_ops.csr_builds == 2 * T
    # the transposed band gets each block's kept rows, not bsize + w - 1
    assert ttm_t_rows == {T // 4}


# ----------------------------------------------------------- AdamW ----------

@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_adamw_matches_jax(schedule):
    rng = np.random.default_rng(9)
    cfg = dict(lr=3e-2, warmup_steps=2, total_steps=7, schedule=schedule,
               weight_decay=0.1, grad_clip=0.5)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    params, tparams = _params("cdgcn", seed=5)
    jstate, tstate = jadamw.init_state(params), adamw.init_state(tparams)
    names = [k for k, _ in tparams.named_parameters()]
    for s in range(1, 8):
        grads = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in _named(params).items()}
        jgrads = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(params),
            [jnp.asarray(grads[k]) for k in _named(params)])
        assert adamw.global_norm([torch.from_numpy(grads[k])
                                  for k in names]) > cfg["grad_clip"]
        np.testing.assert_allclose(
            float(adamw.schedule_lr(tcfg, torch.tensor(s))),
            float(jadamw.schedule_lr(jcfg, jnp.asarray(s))), rtol=1e-6)
        params, jstate = jadamw.apply_updates(jcfg, params, jgrads, jstate)
        tparams, tstate = adamw.apply_updates(
            tcfg, tparams, [torch.from_numpy(grads[k]) for k in names],
            tstate)
        _assert_trees_close(convert.params_to_numpy(tparams),
                            _named(params), 1e-6, 1e-6)
        for key in ("m", "v", "master"):
            _assert_trees_close({k: v.numpy() for k, v in
                                 tstate[key].items()},
                                _named(jstate[key]), 1e-6, 1e-6)
    assert int(tstate["step"]) == int(jstate["step"]) == 7


# ---------------------------------------------------------- Engine ----------

@pytest.mark.parametrize("model", MODELS)
def test_engine_eager_matches_jax_engine(model):
    steps = 12
    jeng = JEngine(JRunConfig(model=_jcfg(model), data=_trace(JTrace, model),
                              plan=JPlan(mode="eager", num_steps=steps),
                              log_fn=_silent))
    want = jeng.fit()
    p0 = jm.init_params(jax.random.PRNGKey(0), _jcfg(model))
    eng = Engine(RunConfig(model=_tcfg(model), data=_trace(SyntheticTrace,
                                                           model),
                           plan=ExecutionPlan(num_steps=steps),
                           log_fn=_silent),
                 params=convert.params_from_jax(jax.tree.map(np.asarray, p0)),
                 device="cpu")
    got = eng.fit()
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    _assert_trees_close(convert.params_to_numpy(got.state.params),
                        _named(want.state.params), 1e-4)
    assert got.state.step == steps
    assert got.transfer_report == want.transfer_report

    # Engine.evaluate (paper §6.4): the same accuracy from each trained run
    # and, from the JAX run's parameters, the same link logits at 1e-5
    for theta, seed in ((0.1, 0), (1.0, 3)):
        acc = jeng.evaluate(want, theta=theta, seed=seed)
        assert eng.evaluate(got, theta=theta, seed=seed) == acc
        trained = trainer.TrainState(
            params=convert.params_from_jax(jax.tree.map(
                np.asarray, want.state.params)), opt_state=None)
        assert eng.evaluate(trained, theta=theta, seed=seed) == acc
    jrr, rr = jeng.resolve(), eng.resolve()
    zj = jckpt.blocked_forward(jrr.cfg, want.state.params, jrr.pipeline.batch,
                               nb=NB)[-1]
    zt = ckpt.blocked_forward(rr.cfg, trained.params, rr.pipeline.batch,
                              nb=NB)[-1]
    pairs = np.concatenate([rr.ds.snapshots[-1], np.random.default_rng(
        4).integers(0, N, size=(64, 2))]).astype(np.int32)
    want_logits = np.asarray(jm.link_logits(want.state.params, zj,
                                            jnp.asarray(pairs)))
    got_logits = tm.link_logits(trained.params, zt, torch.from_numpy(pairs))
    np.testing.assert_allclose(got_logits.detach().numpy(), want_logits,
                               atol=1e-5)
    assert got_logits.shape == (len(pairs), 2)


def test_engine_equals_a_hand_rolled_loop():
    """Engine eager == a loop over ``make_single_device_train_step`` with
    the worker's defaults (seeded init, default AdamW), bit for bit."""
    cfg, num_steps = _tcfg("tmgcn"), 12
    ds = _trace(SyntheticTrace, "tmgcn").build()
    got = Engine(RunConfig(model=cfg, data=InMemoryDTDG(ds),
                           plan=ExecutionPlan(num_steps=num_steps), seed=3,
                           log_fn=_silent), device="cpu").fit()
    pipe = data.DTDGPipeline(ds, nb=cfg.checkpoint_blocks, device="cpu")
    opt_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=10,
                                total_steps=num_steps, weight_decay=0.0)
    params = tm.init_params(torch.Generator().manual_seed(3), cfg)
    opt_state = adamw.init_state(params)
    step_fn = trainer.make_single_device_train_step(cfg, opt_cfg)
    lab = torch.from_numpy(ds.labels)
    want = []
    for _ in range(num_steps):
        params, opt_state, loss = step_fn(params, opt_state, pipe.batch, lab)
        want.append(float(loss))
    assert got.losses == want
    assert got.state.step == num_steps
    for a, b in zip(got.state.params.parameters(), params.parameters()):
        assert torch.equal(a, b)


def test_engine_evaluate_and_launcher_print_the_done_line(capsys):
    launch_train.main(["--arch", "paper_dyngnn", "--steps", "3",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "done: 3 steps, final loss " in out and "link-pred acc " in out
    eng = Engine(RunConfig(model=_tcfg("tmgcn"),
                           data=_trace(SyntheticTrace, "tmgcn"),
                           plan=ExecutionPlan(num_steps=2), log_fn=_silent),
                 device="cpu")
    with pytest.raises(ValueError, match="before fit"):
        eng.evaluate()
    acc = eng.evaluate(eng.fit())
    assert 0.0 <= acc <= 1.0


@pytest.mark.parametrize("flag,item", [
    (["--rescale-at", "2:2"], "require --stream --mesh P"),
    (["--trace", "t.json"], "item 8c"),
    (["--sampled", "--trace", "t.json"], "item 8c"),
    (["--rescale-on-preempt", "2"], "require --stream --mesh P"),
    (["--ckpt-dir"], None)])
def test_launcher_refuses_unported_flags(flag, item, tmp_path, capsys):
    """``--trace`` still waits for its ROADMAP item; the rescale flags
    without ``--stream`` exit with the reference's message; ``--ckpt-dir``
    runs: a 50-step run saves at step 50 (``CheckpointSpec``'s default
    ``every``) and a relaunch to 52 steps resumes there."""
    if item is not None:
        with pytest.raises(SystemExit, match=item):
            launch_train.main(["--arch", "tmgcn", "--device", "cpu", *flag])
        return
    ck = str(tmp_path / "ck")
    base = ["--arch", "tmgcn", "--device", "cpu", *flag, ck]
    launch_train.main(base + ["--steps", "50"])
    assert "done: 50 steps, final loss " in capsys.readouterr().out
    launch_train.main(base + ["--steps", "52"])
    out = capsys.readouterr().out
    assert "resumed from checkpoint step 50" in out
    assert "done: 52 steps, final loss " in out


@pytest.mark.parametrize("plan,item", [
    # the elastic knobs run now (tests/test_torch_elastic.py): the plans
    # validate as the reference's do, and outside a pool of their widths
    # resolve() says what is missing
    (ExecutionPlan(mode="streamed_mesh", shards=2, rescale=((1, 1),),
                   device_budget_bytes=1 << 20), "process group of 2 ranks"),
    (ExecutionPlan(mode="streamed_mesh", rescale=((1, 2),)),
     "rescale width 2 exceeds the 1 attached devices"),
    (ExecutionPlan(mode="streamed_mesh", shards=4, rescale=((2, 4),)),
     "rescale width 4 exceeds the 1 attached devices"),
    (ExecutionPlan(mode="streamed_mesh", shards=4, rescale_on_preempt=2),
     "rescale width 2 exceeds the 1 attached devices"),
    (ExecutionPlan(mode="streamed_mesh", rescale_on_preempt=1,
                   device_budget_bytes=1 << 20), "process group of 1 ranks")])
def test_unported_schedules_raise_naming_their_roadmap_item(plan, item):
    jplan = JPlan(**{f.name: getattr(plan, f.name)
                     for f in dataclasses.fields(plan)})
    jplan.validate()
    assert jplan.rescale_widths == plan.rescale_widths
    eng = Engine(RunConfig(model=_tcfg("tmgcn"),
                           data=_trace(SyntheticTrace, "tmgcn"), plan=plan,
                           log_fn=_silent), device="cpu")
    with pytest.raises(ValueError, match=item):
        eng.resolve()


def test_checkpointing_and_resume_raise_naming_their_roadmap_item(tmp_path):
    """Checkpointing runs now (tests/test_torch_ft.py): a CheckpointSpec
    is accepted, and resume() refuses as the reference does without one
    or without a checkpoint to resume."""
    rc = RunConfig(model=_tcfg("tmgcn"), data=_trace(SyntheticTrace, "tmgcn"),
                   plan=ExecutionPlan(num_steps=2), log_fn=_silent)
    ck = dataclasses.replace(rc, checkpoint=CheckpointSpec(
        str(tmp_path / "d"), every=1))
    with pytest.raises(FileNotFoundError, match="no checkpoint under"):
        Engine(ck, device="cpu").resume()
    assert Engine(ck, device="cpu").fit().state.step == 2
    with pytest.raises(ValueError, match="resume.. needs RunConfig"):
        Engine(rc, device="cpu").resume()
    with pytest.raises(ValueError, match="process group"):
        trainer.make_dyngnn_train_step(_tcfg("tmgcn"), None,
                                       adamw.AdamWConfig())
    with pytest.raises(ValueError, match="a2a_chunks"):
        ExecutionPlan(a2a_chunks=2).validate()


def test_cuda_requests_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")
    rc = RunConfig(model=_tcfg("tmgcn"), data=_trace(SyntheticTrace, "tmgcn"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(rc)
    ds = rc.data.build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dtdg.build_batch(ds.snapshots, ds.frames, N, values=ds.values)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _ = data.DTDGPipeline(ds, nb=2).batch
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "tmgcn", "--steps", "1"])


# --------------------------------------------- host copies, configs ---------

def test_pad_and_smoothing_byte_identical():
    rng = np.random.default_rng(11)
    snaps = [rng.integers(0, N, size=(rng.integers(5, 60), 2)).astype(
        np.int32) for _ in range(7)]
    vals = rng.random(snaps[0].shape[0]).astype(np.float32)
    for v in (None, vals):
        for a, b in zip(pad.pad_edges(snaps[0], 64, v),
                        jpad.pad_edges(snaps[0], 64, v)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        a, b = pad.add_self_loops(snaps[0], N, v), \
            jpad.add_self_loops(snaps[0], N, v)
        np.testing.assert_array_equal(a[0], b[0])
        assert (a[1] is None) == (b[1] is None)
        if v is not None:
            np.testing.assert_array_equal(a[1], b[1])
    assert pad.round_up(130, 128) == jpad.round_up(130, 128) == 256
    with pytest.raises(ValueError, match="exceeds"):
        pad.pad_edges(snaps[0], 2)
    np.testing.assert_array_equal(smoothing.m_transform_matrix(9, 4),
                                  jsmooth.m_transform_matrix(9, 4))
    for fn, arg in (("edge_life", 3), ("m_transform_sparse", 3)):
        for got, want in zip(getattr(smoothing, fn)(snaps, arg),
                             getattr(jsmooth, fn)(snaps, arg)):
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model", MODELS)
def test_dataset_and_batch_match_jax(model):
    jds = _trace(JTrace, model).build()
    ds = _trace(SyntheticTrace, model).build()
    for f in ("frames", "labels"):
        np.testing.assert_array_equal(getattr(ds, f), getattr(jds, f))
    for a, b in zip(ds.snapshots, jds.snapshots):
        np.testing.assert_array_equal(a, b)
    assert (ds.values is None) == (jds.values is None)
    for a, b in zip(ds.values or [], jds.values or []):
        np.testing.assert_array_equal(a, b)
    jpipe = jdata.DTDGPipeline(jds, nb=NB)
    pipe = data.DTDGPipeline(ds, nb=NB, device="cpu")
    assert pipe.max_edges == jpipe.max_edges
    assert pipe.transfer_bytes() == jpipe.transfer_bytes()
    jb, tb = jpipe.batch, pipe.batch
    for f in ("edges", "edge_mask", "frames"):
        a, b = getattr(tb, f).numpy(), np.asarray(getattr(jb, f))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tb.edge_weights.numpy(),
                               np.asarray(jb.edge_weights), atol=1e-6,
                               rtol=1e-6)
    for a, b in zip(pipe.blocked_arrays(), jpipe.blocked_arrays()):
        assert tuple(a.shape) == b.shape
    for ours, theirs in zip(pipe.sharded_streams(2),
                            jpipe.sharded_streams(2), strict=True):
        for a, b in zip(ours, theirs, strict=True):
            assert type(a).__name__ == type(b).__name__
            for f in a.__dataclass_fields__:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("nb", [1, 2, 4])
def test_activation_memory_estimate_is_the_jax_dict(model, nb):
    for n_edges in (1000, 2_097_152):
        assert ckpt.activation_memory_estimate(
            _tcfg(model), n_edges, nb) == jckpt.activation_memory_estimate(
                _jcfg(model), n_edges, nb)


def test_configs_carry_the_jax_training_values():
    from repro.configs import registry as jregistry
    for arch in ("paper_dyngnn", "tmgcn", "cdgcn", "evolvegcn"):
        for make in ("make_config", "make_smoke_config"):
            got = getattr(registry.get_arch(arch), make)()
            want = getattr(jregistry.get_arch(arch), make)()
            for f in ("num_nodes", "num_steps", "checkpoint_blocks",
                      "window", "hidden", "out_dim", "feat_in"):
                assert getattr(got, f) == getattr(want, f), (arch, make, f)
