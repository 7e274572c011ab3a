"""The port's model forward held to the JAX package's.

Parameters come from ``repro.core.models.init_params`` through
``repro_torch.convert.params_from_jax``; inputs are made with numpy from a
seed and given to both.  ``forward_slice`` for all three models, held to
the JAX side with and without Pallas (interpret mode on the CPU), at 1e-5
— the reference's serving tolerance.  On CPU tensors the port runs its
kernels' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gcn as jgcn
from repro.core import models as jm
from repro.core import temporal as jtemporal
from repro.graph import segment as jsegment
from repro_torch import convert
from repro_torch.core import gcn, temporal
from repro_torch.core import models as tm
from repro_torch.graph import segment
from repro_torch.kernels.segment_spmm import ops as spmm_ops

TOL = 1e-5
N, T, E = 24, 4, 90


def _inputs(seed, feat=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, N, feat)).astype(np.float32)
    edges = rng.integers(0, N, size=(T, E, 2)).astype(np.int32)
    mask = (rng.random((T, E)) < 0.8).astype(np.float32)
    edges[mask == 0] = 0
    w = np.stack([np.asarray(jsegment.gcn_edge_weights(
        jnp.asarray(edges[t]), N, jnp.asarray(mask[t]))) for t in range(T)])
    return x, edges, w


def _carries_close(a, b):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(x, y, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("model", ["tmgcn", "cdgcn", "evolvegcn"])
def test_forward_slice_matches_jax(model, use_pallas):
    jcfg = jm.DynGNNConfig(model=model, num_nodes=N, num_steps=2 * T,
                           window=3, use_pallas=use_pallas)
    tcfg = tm.DynGNNConfig(model=model, num_nodes=N, window=3)
    params = jm.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params))
    jc = jm.init_carries(jcfg, params)
    tc = tm.init_carries(tcfg, tparams)
    # two consecutive slices: the second starts from the carried state
    for t_offset, seed in ((0, 1), (T, 2)):
        x, edges, w = _inputs(seed)
        jz, jc = jm.forward_slice(jcfg, params, jnp.asarray(x),
                                  jnp.asarray(edges), jnp.asarray(w), jc,
                                  t_offset)
        with torch.no_grad():
            tz, tc = tm.forward_slice(tcfg, tparams, torch.from_numpy(x),
                                      torch.from_numpy(edges),
                                      torch.from_numpy(w), tc, t_offset)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=TOL,
                                   atol=TOL)
        _carries_close(convert.carries_to_numpy(tc),
                       jax.tree.map(np.asarray, jc))
        logits = tm.classify(tparams, tz).detach().numpy()
        np.testing.assert_allclose(logits,
                                   np.asarray(jm.classify(params, jz)),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("model", ["tmgcn", "cdgcn", "evolvegcn"])
def test_forward_slice_builds_each_snapshots_csr_once(model, monkeypatch):
    """Both layers aggregate over one CSR per snapshot: T builds and
    T x layers products for a T-step slice; the result is the one the
    per-call build gives (held to JAX above)."""
    aggregated = []

    def counted(x, row_ptr, col, w):
        aggregated.append(row_ptr.data_ptr())
        return spmm_ops.segment_spmm_csr_ref(x, row_ptr, col, w)

    cfg = tm.DynGNNConfig(model=model, num_nodes=N, window=3)
    params = tm.init_params(torch.Generator().manual_seed(1), cfg)
    x, edges, w = map(torch.from_numpy, _inputs(8))
    with torch.no_grad():
        want, _ = tm.forward_slice(cfg, params, x, edges, w,
                                   tm.init_carries(cfg, params), 0)
        monkeypatch.setattr(spmm_ops, "segment_spmm_csr", counted)
        monkeypatch.setattr(spmm_ops, "csr_builds", 0)
        got, _ = tm.forward_slice(cfg, params, x, edges, w,
                                  tm.init_carries(cfg, params), 0)
    assert spmm_ops.csr_builds == T
    assert len(aggregated) == T * cfg.num_layers
    # layer l of snapshot t reads the CSR that layer 0 of t read
    assert aggregated[T:] == aggregated[:T] * (cfg.num_layers - 1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("concat_skip", [False, True])
def test_gcn_apply_on_a_prebuilt_csr_matches_jax(concat_skip):
    x, edges, w = _inputs(9, feat=3)
    p = jgcn.init_gcn_params(jax.random.PRNGKey(6), 3, 6)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, p))
    want = jgcn.gcn_apply(p, jnp.asarray(x[0]), jnp.asarray(edges[0]),
                          jnp.asarray(w[0]), N, concat_skip=concat_skip)
    te, tw = torch.from_numpy(edges[0]), torch.from_numpy(w[0])
    with torch.no_grad():
        got = gcn.gcn_apply(tp, torch.from_numpy(x[0]), te, tw, N,
                            concat_skip=concat_skip,
                            csr=spmm_ops.build_csr(te, tw, N))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("model", ["tmgcn", "cdgcn", "evolvegcn"])
def test_param_tree_mirrors_jax_and_round_trips(model):
    jcfg = jm.DynGNNConfig(model=model, num_nodes=N)
    params = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params))
    flat = convert.params_to_numpy(tparams)
    want = {jax.tree_util.keystr(k, simple=True, separator="."): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert set(flat) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v)
    # the port's own init has the same tree and shapes
    own = tm.init_params(torch.Generator().manual_seed(0),
                         tm.DynGNNConfig(model=model, num_nodes=N))
    assert {k: v.shape for k, v in convert.params_to_numpy(own).items()} \
        == {k: v.shape for k, v in want.items()}
    assert "classifier.u" in flat and tparams["classifier"]["u"].shape == \
        (jcfg.out_dim, jcfg.num_classes)


@pytest.mark.parametrize("concat_skip,pre_aggregated",
                         [(False, False), (True, False), (False, True)])
def test_gcn_apply_matches_jax(concat_skip, pre_aggregated):
    x, edges, w = _inputs(4, feat=3)
    p = jgcn.init_gcn_params(jax.random.PRNGKey(5), 3, 6)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, p))
    want = jgcn.gcn_apply(p, jnp.asarray(x[0]), jnp.asarray(edges[0]),
                          jnp.asarray(w[0]), N, concat_skip=concat_skip,
                          pre_aggregated=pre_aggregated)
    with torch.no_grad():
        got = gcn.gcn_apply(tp, torch.from_numpy(x[0]),
                            torch.from_numpy(edges[0]),
                            torch.from_numpy(w[0]), N,
                            concat_skip=concat_skip,
                            pre_aggregated=pre_aggregated)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_laplacian_weights_and_degrees_match_jax():
    rng = np.random.default_rng(6)
    edges = rng.integers(0, N, size=(E, 2)).astype(np.int32)
    mask = (rng.random(E) < 0.7).astype(np.float32)
    vals = rng.random(E).astype(np.float32)
    got = segment.gcn_edge_weights(torch.from_numpy(edges), N,
                                   torch.from_numpy(mask),
                                   torch.from_numpy(vals)).numpy()
    want = jsegment.gcn_edge_weights(jnp.asarray(edges), N,
                                     jnp.asarray(mask), jnp.asarray(vals))
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(
        segment.in_degree(torch.from_numpy(edges), N).numpy(),
        np.asarray(jsegment.in_degree(jnp.asarray(edges), N)))


def test_lstm_and_weight_evolution_match_jax():
    rng = np.random.default_rng(7)
    p = jtemporal.init_lstm_params(jax.random.PRNGKey(8), 5, 4)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, p))
    x = rng.normal(size=(6, N, 5)).astype(np.float32)
    jy, jst = jtemporal.lstm_scan(p, jnp.asarray(x))
    with torch.no_grad():
        ty, tst = temporal.lstm_scan(tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    _carries_close(convert.carries_to_numpy(tst),
                   jax.tree.map(np.asarray, jst))

    ep = jtemporal.init_weight_lstm_params(jax.random.PRNGKey(9), 3, 6)
    tep = convert.params_from_jax(jax.tree.map(np.asarray, ep))
    state = jtemporal.lstm_zero_state((6,), 3)
    jws, jw, jst = jtemporal.evolve_weights_from(ep, ep["w0"], state, 5)
    with torch.no_grad():
        tws, tw, tst = temporal.evolve_weights_from(
            tep, tep["w0"], convert.carries_from_jax(
                jax.tree.map(np.asarray, state)), 5)
    np.testing.assert_allclose(tws.numpy(), np.asarray(jws), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=TOL,
                               atol=TOL)
