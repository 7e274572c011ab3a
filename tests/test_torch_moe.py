"""The port's MoE FFN (``repro_torch.nn.moe``) held to ``repro.nn.moe`` on
the CPU.

Parameters come from the JAX package's ``init_moe`` and cross through
``repro_torch.convert.lm_params_from_jax``; inputs are numpy draws from
fixed seeds.  Tolerances: outputs 1e-4 (abs and rel; the reference's own
MoE checks, ``tests/test_lm.py``), the load-balance loss 1e-6 and
gradients 1e-5 (``tests/test_perf_variants.py``), fp32 sums taken in
another order; the dropped fraction exactly (the same stable expert
order decides the same overflow).  bf16: 2e-2, the reference's bf16
tolerance (``tests/test_kernels.py``).  The MoE has no Pallas kernel in
the reference, so none here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import moe as jmoe
from repro_torch import convert
from repro_torch.nn import moe

TOL = 1e-4
TOL_GRAD = 1e-5


def _params(seed, d, f, e, dtype=jnp.float32):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), d, f, e, dtype)
    return jp, convert.lm_params_from_jax(jax.tree.map(np.asarray, jp))


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_init_moe_has_the_reference_tree(dtype):
    jp, _ = _params(0, 32, 48, 4, dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tp = moe.init_moe(torch.Generator().manual_seed(0), 32, 48, 4, tdt,
                      lead=(3,))
    for k, leaf in jp.items():
        assert tuple(tp[k].shape) == (3,) + leaf.shape, k
        assert str(tp[k].dtype).split(".")[-1] == jnp.dtype(leaf.dtype).name
    assert tp["router"].dtype == torch.float32
    # the router is drawn in the model's dtype, then widened
    np.testing.assert_array_equal(
        tp["router"].to(tdt).to(torch.float32).numpy(),
        tp["router"].numpy())
    # scales: N(0, 1/d) in, N(0, 1/ff) out
    big = moe.init_moe(torch.Generator().manual_seed(1), 256, 512, 8,
                       torch.float32)
    assert abs(float(big["wi_up"].std()) * 16 - 1) < 0.02
    assert abs(float(big["wo"].std()) * 512 ** 0.5 - 1) < 0.02


@pytest.mark.parametrize("t,k,e,cf", [(32, 2, 8, 1.25), (32, 2, 8, 8.0),
                                      (4, 8, 64, 1.25), (32768, 8, 64, 1.25),
                                      (8192, 8, 64, 1.25), (100, 3, 7, 0.5)])
def test_moe_capacity_is_the_references(t, k, e, cf):
    want = max(8, -(-int(cf * t * k / e) // 8) * 8)
    assert moe.moe_capacity(t, k, e, cf) == want
    assert want % 8 == 0


@pytest.mark.parametrize("cf,activation", [(8.0, "silu"), (1.25, "silu"),
                                           (0.25, "silu"), (1.25, "gelu")])
def test_moe_apply_matches_jax(cf, activation):
    """Generous (nothing dropped), default and tight capacity: the same
    dropped fraction, the same outputs and load-balance loss."""
    jp, tp = _params(0, 32, 64, 8)
    x = _x(1, 2, 16, 32)
    want, jaux = jmoe.moe_apply(jp, jnp.asarray(x), 2, cf, activation)
    got, aux = moe.moe_apply(tp, torch.from_numpy(x), 2, cf, activation)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want)
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"])
    np.testing.assert_allclose(float(aux["lb_loss"]),
                               float(jaux["lb_loss"]), rtol=1e-6)
    if cf == 8.0:
        assert float(aux["dropped_frac"]) == 0.0
    if cf == 0.25:
        assert float(aux["dropped_frac"]) > 0.0


@pytest.mark.parametrize("capacity", [8, 16])
def test_moe_explicit_capacity_matches_jax(capacity):
    jp, tp = _params(2, 16, 24, 4)
    x = _x(3, 1, 40, 16)
    want, jaux = jmoe.moe_apply(jp, jnp.asarray(x), 2, capacity=capacity)
    got, aux = moe.moe_apply(tp, torch.from_numpy(x), 2, capacity=capacity)
    _close(got, want)
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"]) > 0


def test_moe_matches_dense_expert_sum():
    """With capacity ample, the sort-based dispatch equals the direct
    per-token expert computation."""
    e, d, f, topk = 4, 16, 32, 2
    _, tp = _params(1, d, f, e)
    x = torch.from_numpy(_x(3, 1, 8, d))
    out, _ = moe.moe_apply(tp, x, top_k=topk, capacity_factor=16.0)
    tokens = x.reshape(-1, d)
    probs = torch.softmax(tokens @ tp["router"], -1)
    gv, ei = torch.topk(probs, topk, -1)
    gv = gv / gv.sum(-1, keepdim=True)
    ref = torch.zeros_like(tokens)
    for t in range(tokens.shape[0]):
        for j in range(topk):
            ex = int(ei[t, j])
            h = tokens[t] @ tp["wi_gate"][ex]
            u = tokens[t] @ tp["wi_up"][ex]
            ref[t] += gv[t, j] * ((torch.nn.functional.silu(h) * u)
                                  @ tp["wo"][ex])
    _close(out.reshape(-1, d), ref.numpy())


def test_moe_gradients_match_jax():
    """Gradients into x and every parameter, through the gates, the
    gathers and the load-balance loss, at a capacity that drops."""
    jp, tp = _params(4, 16, 32, 8)
    x = _x(5, 2, 40, 16)
    r = _x(6, 2, 40, 16)

    def jloss(p, xx):
        out, aux = jmoe.moe_apply(p, xx, 2, 0.5)
        return jnp.sum(out * r) + aux["lb_loss"]

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_apply(tp, xt, 2, 0.5)
    assert float(aux["dropped_frac"]) > 0
    (torch.sum(out * torch.from_numpy(r)) + aux["lb_loss"]).backward()
    _close(xt.grad, want_x, TOL_GRAD)
    for k in tp:
        _close(tp[k].grad, want_p[k], TOL_GRAD)


def test_moe_bf16_matches_jax():
    """bf16 experts beside the fp32 router: the same routing, outputs in
    bf16 within the reference's bf16 tolerance."""
    jp, tp = _params(7, 64, 128, 8, jnp.bfloat16)
    assert tp["router"].dtype == torch.float32
    assert tp["wi_gate"].dtype == torch.bfloat16
    x = _x(8, 2, 16, 64)
    want, jaux = jmoe.moe_apply(jp, jnp.asarray(x, jnp.bfloat16), 2)
    got, aux = moe.moe_apply(tp, torch.from_numpy(x).to(torch.bfloat16), 2)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), 2e-2)
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"])


def test_moe_decode_shape_routes_the_batch_as_one():
    """Decode calls the MoE on (B, 1, d): the capacity comes from T = B
    (at least 8 slots an expert), so nothing drops at small B."""
    jp, tp = _params(9, 32, 64, 16)
    x = _x(10, 4, 1, 32)
    want, jaux = jmoe.moe_apply(jp, jnp.asarray(x), 4)
    got, aux = moe.moe_apply(tp, torch.from_numpy(x), 4)
    _close(got, want)
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"]) == 0.0
