"""The port's ``nn/embedding`` held to ``repro.nn.embedding`` on the CPU.

Every function on the same tables and ids (numpy, from a seed): values and
the gradients of a random projection of the output into the table (and
into the weights of the segment form) at rtol 1e-5 / atol 1e-6.  The bag
modes run on a mask with an empty bag, a bag with one valid slot and
repeated ids (ties in ``max``); the segment form with and without weights,
with an empty bag and segment ids out of order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import embedding as jemb
from repro_torch.nn import embedding as temb

RTOL, ATOL = 1e-5, 1e-6
VOCAB, DIM, B, L = 50, 6, 5, 7


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _table(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(VOCAB, DIM)).astype(
        np.float32)


def _bags(seed: int = 1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (B, L)).astype(np.int32)
    ids[3, :3] = ids[3, 3]                  # a repeated id: ties in max
    mask = (rng.random((B, L)) < 0.6).astype(np.float32)
    mask[1] = 0.0                           # a bag with no valid slot
    mask[2] = 0.0
    mask[2, 4] = 1.0                        # one valid slot
    mask[3, :4] = 1.0
    return ids, mask


def _value_and_table_grad_jax(fn, table, cot):
    out, vjp = jax.vjp(fn, jnp.asarray(table))
    return out, vjp(jnp.asarray(cot))[0]


def _value_and_table_grad_torch(fn, table, cot):
    t = torch.tensor(table, requires_grad=True)
    out = fn(t)
    out.backward(torch.from_numpy(cot))
    return out.detach(), t.grad


def test_init_table_shape_dtype_and_scale():
    gen = torch.Generator().manual_seed(0)
    t = temb.init_table(gen, 1000, 8)
    j = jemb.init_table(jax.random.PRNGKey(0), 1000, 8)
    assert t.shape == j.shape == (1000, 8)
    assert t.dtype == torch.float32 and j.dtype == jnp.float32
    assert abs(float(t.std()) - 0.01) < 5e-4
    assert temb.init_table(gen, 4, 3, torch.bfloat16).dtype == torch.bfloat16


def test_embedding_lookup_any_shape():
    table = _table()
    ids = np.random.default_rng(2).integers(0, VOCAB, (3, 4, 2)).astype(
        np.int32)
    cot = np.random.default_rng(3).normal(size=(3, 4, 2, DIM)).astype(
        np.float32)
    jv, jg = _value_and_table_grad_jax(
        lambda t: jemb.embedding_lookup(t, jnp.asarray(ids)), table, cot)
    tv, tg = _value_and_table_grad_torch(
        lambda t: temb.embedding_lookup(t, torch.from_numpy(ids)), table, cot)
    _close(tv, jv)
    _close(tg, jg)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_modes(mode):
    table = _table()
    ids, mask = _bags()
    cot = np.random.default_rng(4).normal(size=(B, DIM)).astype(np.float32)
    jv, jg = _value_and_table_grad_jax(
        lambda t: jemb.embedding_bag(t, jnp.asarray(ids), jnp.asarray(mask),
                                     mode), table, cot)
    tv, tg = _value_and_table_grad_torch(
        lambda t: temb.embedding_bag(t, torch.from_numpy(ids),
                                     torch.from_numpy(mask), mode),
        table, cot)
    _close(tv, jv)
    _close(tg, jg)
    # the empty bag: 0 in every mode, and no gradient from it
    assert float(tv[1].abs().max()) == 0.0
    if mode == "max":
        np.testing.assert_array_equal(tv[2].numpy(), table[ids[2, 4]])


def test_embedding_bag_rejects_an_unknown_mode():
    ids, mask = _bags()
    with pytest.raises(ValueError):
        temb.embedding_bag(torch.from_numpy(_table()), torch.from_numpy(ids),
                           torch.from_numpy(mask), "median")


@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_segment(weighted):
    rng = np.random.default_rng(5)
    table = _table()
    n_flat, num_bags = 17, 6
    flat_ids = rng.integers(0, VOCAB, (n_flat,)).astype(np.int32)
    seg = rng.integers(0, num_bags, (n_flat,)).astype(np.int32)
    seg[seg == 4] = 5                       # bag 4 stays empty
    w = rng.normal(size=(n_flat,)).astype(np.float32)
    cot = rng.normal(size=(num_bags, DIM)).astype(np.float32)

    def jfn(t, wj):
        return jemb.embedding_bag_segment(
            t, jnp.asarray(flat_ids), jnp.asarray(seg), num_bags,
            wj if weighted else None)

    jv, vjp = jax.vjp(jfn, jnp.asarray(table), jnp.asarray(w))
    jg_table, jg_w = vjp(jnp.asarray(cot))
    tt = torch.tensor(table, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    tv = temb.embedding_bag_segment(tt, torch.from_numpy(flat_ids),
                                    torch.from_numpy(seg), num_bags,
                                    tw if weighted else None)
    tv.backward(torch.from_numpy(cot))
    _close(tv.detach(), jv)
    _close(tt.grad, jg_table)
    if weighted:
        _close(tw.grad, jg_w)
    else:
        assert tw.grad is None
    assert tv.shape == (num_bags, DIM)
    assert float(tv.detach()[4].abs().max()) == 0.0
