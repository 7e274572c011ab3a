"""The port's EquiformerV2 held to the JAX package on the CPU, and its own
invariances.

As ``tests/test_torch_gnn.py`` does for the other archs: the smoke config
(2 layers, C 16, l_max 3, m_max 2, 4 heads), the reference cell's
parameters through ``params_from_jax``, logits and the cell loss at 1e-4
against the reference in f32 and the gradients at 1e-4 x each leaf's max
against its float64 ``jax.grad``, at the ``molecule`` and ``full_graph``
kinds (a masked edge in each; the full graph's 68 padding lanes masked).
Three AdamW steps beside the reference cell's (``gnn_parity.
check_three_steps``: losses rtol 1e-5, parameters 1e-4 x each leaf's
max).  Then rotation and translation invariance of the port's logits at 1e-4,
the reference's ``tests/test_equiformer.py`` cases, and finite gradients.
"""

import dataclasses

import numpy as np
import pytest
import torch

import gnn_parity as gp
from repro_torch.models.gnn import common, equiformer_v2 as eq

TOL = 1e-4


@pytest.mark.parametrize("kind", ["molecule", "full_graph"])
def test_logits_and_gradients_match_jax(kind):
    gp.check_arch("equiformer-v2", kind, TOL)


def test_three_adamw_steps_match_the_reference_cell():
    gp.check_three_steps("equiformer-v2", "molecule")


def _rot(a, b, g):
    def rz(t):
        return np.array([[np.cos(t), -np.sin(t), 0],
                         [np.sin(t), np.cos(t), 0], [0, 0, 1]])

    def ry(t):
        return np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0],
                         [-np.sin(t), 0, np.cos(t)]])

    return rz(a) @ ry(b) @ rz(g)


def _logits(batch, seed, c, l_max, m_max, heads, n_rbf, classes):
    p = eq.init_params(torch.Generator().manual_seed(seed), 5, c, 2, l_max,
                       m_max, heads, n_rbf, classes)
    with torch.no_grad():
        return eq.logits(p, batch, l_max=l_max, m_max=m_max,
                         n_heads=heads, n_rbf=n_rbf)


def test_rotation_invariance():
    """Rotating every position by R leaves the logits unchanged."""
    r = torch.from_numpy(_rot(0.7, 1.2, -0.3).astype(np.float32))
    batch = common.batch_molecules(4, 8, 16, feat_dim=5, seed=0)
    batch.edge_mask[3] = 0.0
    turned = dataclasses.replace(batch, positions=batch.positions @ r.T)
    kw = dict(c=16, l_max=4, m_max=2, heads=4, n_rbf=8, classes=3)
    np.testing.assert_allclose(_logits(batch, 0, **kw).numpy(),
                               _logits(turned, 0, **kw).numpy(), atol=TOL)


def test_translation_invariance():
    batch = common.batch_molecules(2, 6, 12, feat_dim=5, seed=1)
    shifted = dataclasses.replace(batch, positions=batch.positions + 7.5)
    kw = dict(c=8, l_max=2, m_max=1, heads=2, n_rbf=6, classes=2)
    np.testing.assert_allclose(_logits(batch, 1, **kw).numpy(),
                               _logits(shifted, 1, **kw).numpy(), atol=TOL)


def test_gradients_are_finite_with_a_zero_length_edge():
    """A degenerate edge (src and dst at one point) has no frame: it is
    masked, and every gradient stays finite."""
    batch = common.batch_molecules(2, 6, 12, feat_dim=5, seed=2)
    batch.positions[batch.edges[0, 1]] = batch.positions[batch.edges[0, 0]]
    p = eq.init_params(torch.Generator().manual_seed(2), 5, 8, 2, 3, 2, 2,
                       6, 2)
    leaves = [v for layer in p["layers"] for v in layer.values()
              if isinstance(v, torch.Tensor)] + [p["embed"], p["out2"]]
    for v in leaves:
        v.requires_grad_()
    out = eq.logits(p, batch, l_max=3, m_max=2, n_heads=2, n_rbf=6)
    grads = torch.autograd.grad((out ** 2).sum(), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
