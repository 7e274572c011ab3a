"""The port's static GNNs (GatedGCN, PNA, SchNet) held to the JAX package
on the CPU.

Parameters are the reference cell's init (``_gnn_init_fn``) carried across
by ``repro_torch.convert.params_from_jax``; batches are the port's
``launch.steps.gnn_batch_arrays`` at small shapes (each with a masked
edge; the full graph's padding lanes masked too), given to both.  Logits
and the cell loss at 1e-4 (abs and rel) against the reference in f32, and
the loss's gradients at 1e-4 x each leaf's max |value| against
``jax.grad`` of the reference in float64 -- the reference GNN tests' 1e-4
(``tests/test_equiformer.py``) -- at the ``molecule``, ``full_graph`` and
``minibatch`` kinds.  (The f64 gradient: PNA's std aggregator amplifies
f32 rounding, and the reference's own jitted f32 gradient lies up to
2e-4 x the leaf max from its f64 one, the port's within 6e-5.)  Then the
copied ``batch_molecules`` byte for byte, the four archs' trees through
``params_from_jax``, and GatedGCN / PNA permutation equivariance at 1e-4.
EquiformerV2 is in ``tests/test_torch_equiformer.py``.
"""

import numpy as np
import pytest
import torch

import gnn_parity as gp
from repro.models.gnn import common as jcommon
from repro_torch.launch import steps
from repro_torch.models.gnn import common, gatedgcn, pna

TOL = 1e-4


@pytest.mark.parametrize("kind", ["molecule", "full_graph", "minibatch"])
@pytest.mark.parametrize("arch", ["gatedgcn", "pna", "schnet"])
def test_logits_and_gradients_match_jax(arch, kind):
    gp.check_arch(arch, kind, TOL)


def test_minibatch_batch_is_the_sampled_tree():
    """4 seeds, fanouts 3 then 2: each hop's children point at their
    parent; 36 edges, 40 nodes, as the reference cell's dims."""
    shape = gp.SHAPES["minibatch"]
    assert steps.gnn_dims(shape) == {"d_in": 7, "num_classes": 3,
                                     "nodes": 40, "edges": 36, "seeds": 4}
    (a,) = steps.gnn_batch_arrays(shape)
    src, dst = a["edges"][:, 0], a["edges"][:, 1]
    np.testing.assert_array_equal(src, np.arange(4, 40))
    np.testing.assert_array_equal(dst[:12], np.arange(12) // 3)
    np.testing.assert_array_equal(dst[12:], 4 + np.arange(24) // 2)
    full = steps.gnn_batch_arrays(gp.SHAPES["full_graph"])[0]
    assert full["edges"].shape == (128, 2)
    assert full["edge_mask"].sum() == 60
    assert (full["edges"][:60, 0] != full["edges"][:60, 1]).all()


@pytest.mark.parametrize("seed", [0, 3])
def test_batch_molecules_is_byte_identical(seed):
    want = jcommon.batch_molecules(5, 7, 11, 4, seed=seed)
    got = common.batch_molecules(5, 7, 11, 4, seed=seed)
    assert got.num_graphs == want.num_graphs == 5
    for f in ("edges", "edge_mask", "node_feat", "node_mask", "positions",
              "graph_id", "labels"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    bare = common.batch_molecules(2, 3, 4, 2, with_positions=False)
    assert bare.positions is None
    assert bare.to("cpu").edges.dtype == torch.int32


@pytest.mark.parametrize("arch", gp.ARCHS)
def test_param_trees_cross_through_params_from_jax(arch):
    """Every leaf of the reference's tree (nested dicts and lists;
    EquiformerV2's stacked (L + 1, C, C) ``proj``) lands under its path,
    bit for bit, and the port's own init builds the same tree."""
    jcfg, tcfg = gp.configs(arch)
    shape = gp.SHAPES["molecule"]
    want = gp.flat(gp.jax_params(arch, jcfg, shape))
    params = gp.port_params(gp.jax_params(arch, jcfg, shape))
    got = {n: p.detach().numpy() for n, p in params.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, v in got.items():
        assert v.dtype == want[name].dtype and v.tobytes() == \
            want[name].tobytes(), name
    own, opt = steps.gnn_train_state(torch.Generator().manual_seed(0),
                                     arch, tcfg, 6, 2)
    shapes = {n: tuple(p.shape) for n, p in own.named_parameters()}
    assert shapes == {n: v.shape for n, v in want.items()}
    assert list(opt["m"]) == list(dict(own.named_parameters()))
    if arch == "equiformer-v2":
        assert want["layers.0.proj"].shape == (tcfg.l_max + 1,) + (
            tcfg.d_hidden,) * 2


def _perm_batches(seed: int):
    rng = np.random.default_rng(seed)
    n, e, f = 20, 60, 5
    edges = rng.integers(0, n, size=(e, 2)).astype(np.int32)
    feat = rng.normal(size=(n, f)).astype(np.float32)
    mask = np.ones((e,), np.float32)
    mask[[4, 9]] = 0.0
    perm = rng.permutation(n)
    inv = np.argsort(perm)

    def batch(ed, ft):
        return common.GraphBatch(
            edges=torch.from_numpy(ed), edge_mask=torch.from_numpy(mask),
            node_feat=torch.from_numpy(ft),
            node_mask=torch.ones((n,)))

    return (batch(edges, feat),
            batch(perm[edges].astype(np.int32), feat[inv]), inv, f)


@pytest.mark.parametrize("arch", ["gatedgcn", "pna"])
def test_permutation_equivariance(arch):
    """Relabelling the nodes permutes the node outputs (the reference's
    ``test_gnn_archs_permutation_equivariance``)."""
    b, bp, inv, f = _perm_batches(0)
    gen = torch.Generator().manual_seed(0)
    if arch == "gatedgcn":
        p, mod = gatedgcn.init_params(gen, f, 16, 2, 2), gatedgcn
    else:
        p, mod = pna.init_params(gen, f, 12, 2, 2), pna
    with torch.no_grad():
        h1, h2 = mod.forward(p, b), mod.forward(p, bp)
    np.testing.assert_allclose(h2.numpy(), h1.numpy()[inv], atol=TOL)


def test_registry_resolves_a_gnn_arch_after_one_config_import():
    """A process that imported one config module first (as a caller of
    ``configs.paper_dyngnn.DATASETS`` does) still resolves every arch."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run(
        [sys.executable, "-c",
         "from repro_torch.configs.paper_dyngnn import DATASETS\n"
         "from repro_torch.configs import registry\n"
         "print(registry.get_arch('gatedgcn').family,"
         " sorted(registry.get_arch('pna').shapes))"],
        capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(src)),
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["gnn", "['full_graph_sm',",
                                  "'minibatch_lg',", "'molecule',",
                                  "'ogb_products']"]
