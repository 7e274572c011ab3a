"""The port's segment gathers / scatters and its SO(3) machinery held to
the JAX package on the CPU.

Inputs are numpy draws from fixed seeds, given to both.  Every
``repro_torch.graph.segment`` gather and ``scatter_*`` op is compared in
values and in gradients (``jax.grad`` / ``torch.autograd.grad`` of the
output weighted by a fixed random tensor) at 1e-5, with and without an
edge mask, on a graph with a node that has no in-edge, a node whose every
in-edge is masked, and tied messages (small integers, so max / min tie
and share their gradient).  ``models.gnn.so3``: the copied numpy tables
byte for byte, ``wigner_d_real`` for l = 0..6 at 1e-5 (the tolerance of
``tests/test_equiformer.py``), the edge angles and the block rotation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import segment as jseg
from repro.models.gnn import so3 as jso3
from repro_torch.graph import segment
from repro_torch.models.gnn import so3

TOL = 1e-5
N, E = 12, 48
EMPTY, MASKED = 10, 11          # no in-edge / every in-edge masked


def _graph(seed: int, feat: tuple = (5,), ties: bool = False):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, EMPTY, size=E)
    dst[:3] = MASKED
    edges = np.stack([rng.integers(0, N, size=E), dst], 1).astype(np.int32)
    mask = (rng.random(E) < 0.75).astype(np.float32)
    mask[:3] = 0.0
    msgs = (rng.integers(-2, 3, size=(E,) + feat) if ties
            else rng.normal(size=(E,) + feat)).astype(np.float32)
    return edges, mask, msgs, rng


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=tol, atol=tol)


SCATTERS = ("scatter_sum", "scatter_mean", "scatter_max", "scatter_min",
            "scatter_std", "scatter_softmax")


@pytest.mark.parametrize("op", SCATTERS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_scatter_matches_jax(op, masked, ties):
    edges, mask, msgs, rng = _graph(3, (5,), ties)
    dst = edges[:, 1]
    w = rng.normal(size=(E, 5) if op == "scatter_softmax"
                   else (N, 5)).astype(np.float32)
    m = mask if masked else None
    jfn, tfn = getattr(jseg, op), getattr(segment, op)

    def jloss(x):
        out = jfn(x, jnp.asarray(dst), N,
                  None if m is None else jnp.asarray(m))
        return jnp.sum(out * w), out

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(msgs))
    x = torch.from_numpy(msgs).requires_grad_()
    got = tfn(x, torch.from_numpy(dst), N,
              None if m is None else torch.from_numpy(m))
    (grad,) = torch.autograd.grad(torch.sum(got * torch.from_numpy(w)), x)
    _close(got, want)
    _close(grad, jgrad)
    if op not in ("scatter_softmax", "scatter_std"):  # std: sqrt(eps)
        assert float(got[EMPTY].detach().abs().max()) == 0.0  # no in-edge
        if masked:
            assert float(got[MASKED].detach().abs().max()) == 0.0


@pytest.mark.parametrize("msgs,dst,want", [
    ([3.0, 3.0, 1.0, 2.0], [0, 0, 0, 1], [0.5, 0.5, 0.0, 1.0]),
    # a tie at 0, PNA's relu outputs: an initial 0 is no extra tie
    ([0.0, 0.0, 1.0], [0, 0, 1], [0.5, 0.5, 1.0]),
])
def test_scatter_max_splits_tied_gradients_evenly(msgs, dst, want):
    """Tied maxima share the gradient evenly, in both packages."""
    msgs = np.array(msgs, np.float32)
    dst = np.array(dst, np.int32)
    jg = jax.grad(lambda x: jnp.sum(jseg.scatter_max(x, jnp.asarray(dst),
                                                     2)))(jnp.asarray(msgs))
    x = torch.from_numpy(msgs).requires_grad_()
    (tg,) = torch.autograd.grad(segment.scatter_max(
        x, torch.from_numpy(dst), 2).sum(), x)
    np.testing.assert_array_equal(np.asarray(jg), want)
    np.testing.assert_array_equal(tg.numpy(), want)


@pytest.mark.parametrize("feat", [(5,), (4, 3)])
def test_scatter_sum_of_higher_rank_messages(feat):
    """(E, dim, C) messages, as EquiformerV2 aggregates them."""
    edges, mask, msgs, _ = _graph(5, feat)
    want = jseg.scatter_sum(jnp.asarray(msgs), jnp.asarray(edges[:, 1]), N,
                            jnp.asarray(mask))
    got = segment.scatter_sum(torch.from_numpy(msgs),
                              torch.from_numpy(edges[:, 1]), N,
                              torch.from_numpy(mask))
    _close(got, want)


@pytest.mark.parametrize("side", ["gather_src", "gather_dst"])
def test_gathers_match_jax(side):
    edges, _, _, rng = _graph(7)
    x = rng.normal(size=(N, 6)).astype(np.float32)
    w = rng.normal(size=(E, 6)).astype(np.float32)
    jfn, tfn = getattr(jseg, side), getattr(segment, side)
    want, jgrad = jax.value_and_grad(
        lambda v: jnp.sum(jfn(v, jnp.asarray(edges)) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tfn(xt, torch.from_numpy(edges))
    (grad,) = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)), xt)
    _close(out, jfn(jnp.asarray(x), jnp.asarray(edges)))
    _close(grad, jgrad)


# ----------------------------------------------------------------- so3 ----

@pytest.mark.parametrize("l", range(7))
def test_so3_tables_are_byte_identical(l):
    for a, b in zip(so3._wigner_d_tables(l), jso3._wigner_d_tables(l),
                    strict=True):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    u, v = so3._real_u_matrix(l), jso3._real_u_matrix(l)
    assert u.dtype == v.dtype and u.tobytes() == v.tobytes()
    assert so3.block_slices(l) == jso3.block_slices(l)
    assert so3.irreps_dim(l) == jso3.irreps_dim(l)


@pytest.mark.parametrize("l", range(7))
def test_wigner_d_real_matches_jax(l):
    rng = np.random.default_rng(l)
    a, b, g = (rng.uniform(-np.pi, np.pi, 16).astype(np.float32)
               for _ in range(3))
    want = jso3.wigner_d_real(l, *(jnp.asarray(v) for v in (a, b, g)))
    got = so3.wigner_d_real(l, *(torch.from_numpy(v) for v in (a, b, g)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want)


def test_edge_angles_and_rotation_match_jax():
    rng = np.random.default_rng(11)
    vec = rng.normal(size=(20, 3)).astype(np.float32)
    vec[0] = [0.0, 0.0, 2.0]                  # on the z axis
    vec[1] = [0.0, 0.0, 0.0]                  # degenerate: masked later
    feats = rng.normal(size=(20, 16, 5)).astype(np.float32)
    jang = jso3.edge_rotation_angles(jnp.asarray(vec))
    tang = so3.edge_rotation_angles(torch.from_numpy(vec))
    for got, want in zip(tang, jang, strict=True):
        _close(got, want)
    jd = jso3.wigner_d_real_stack(3, *jang)
    td = so3.wigner_d_real_stack(3, *tang)
    for inverse in (False, True):
        want = jso3.rotate_features(jnp.asarray(feats), jd, 3, inverse)
        got = so3.rotate_features(torch.from_numpy(feats), td, 3, inverse)
        _close(got, want)
    # the rotation is orthogonal: its inverse undoes it
    back = so3.rotate_features(so3.rotate_features(
        torch.from_numpy(feats), td, 3), td, 3, inverse=True)
    _close(back, feats)
