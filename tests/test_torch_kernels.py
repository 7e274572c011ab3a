"""The port's kernel wrappers held to the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version on the
CSR / band the CUDA kernel would get; the JAX side runs the Pallas kernel
in interpret mode and through its dense oracle.  The CUDA kernels
themselves are held to these plain versions on the card by
``chip_smoke.py``.  Tolerances are the reference's own:
segment SpMM 1e-4 (``tests/test_kernels.py:39``), M-product 1e-5 (``:85``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import temporal as jtemporal
from repro.kernels.mproduct import mproduct as jmp
from repro.kernels.mproduct import ops as jmp_ops
from repro.kernels.segment_spmm import ops as jspmm_ops
from repro_torch.core import temporal
from repro_torch.kernels import build
from repro_torch.kernels.mproduct import ops as mp_ops
from repro_torch.kernels.segment_spmm import ops as spmm_ops

SPMM_TOL = 1e-4
MP_TOL = 1e-5


def _graph(seed, n, e, f):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(e, 2)).astype(np.int32)
    w = rng.normal(size=(e,)).astype(np.float32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    return x, edges, w


def _check_spmm(x, edges, w, n):
    got = spmm_ops.segment_spmm(torch.from_numpy(x), torch.from_numpy(edges),
                                torch.from_numpy(w), n).numpy()
    args = (jnp.asarray(x), jnp.asarray(edges), jnp.asarray(w), n)
    pallas = jspmm_ops.segment_spmm(*args, interpret=True)
    oracle = jspmm_ops.segment_spmm_ref(*args)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want), rtol=SPMM_TOL,
                                   atol=SPMM_TOL)


@pytest.mark.parametrize("n,e,f", [(200, 1000, 6), (300, 2000, 2),
                                   (64, 64, 32), (129, 700, 9)])
def test_segment_spmm_matches_pallas_and_oracle(n, e, f):
    _check_spmm(*_graph(n + e, n, e, f), n)


def test_segment_spmm_zero_weight_pad_lanes_at_origin():
    """``apply_delta`` parks padded lanes at edge (0, 0) with weight 0:
    they land in the dump row and add nothing to destination 0."""
    n, e, f = 50, 400, 6
    x, edges, w = _graph(0, n, e, f)
    edges[e // 2:] = 0
    w[e // 2:] = 0.0
    _check_spmm(x, edges, w, n)
    row_ptr, col, wc = spmm_ops.build_csr(torch.from_numpy(edges),
                                          torch.from_numpy(w), n)
    assert int(row_ptr[-1]) == int((w != 0).sum())
    assert (wc[int(row_ptr[-1]):] == 0).all()


def test_segment_spmm_all_edges_into_one_destination():
    n, e, f = 40, 3000, 6
    x, edges, w = _graph(1, n, e, f)
    edges[:, 1] = 7
    _check_spmm(x, edges, w, n)


def test_build_csr_is_destination_sorted_and_stable():
    n = 30
    x, edges, w = _graph(2, n, 500, 2)
    w[::7] = 0.0
    row_ptr, col, wc = spmm_ops.build_csr(torch.from_numpy(edges),
                                          torch.from_numpy(w), n)
    assert row_ptr.dtype == torch.int32 and col.dtype == torch.int32
    for r in range(n):
        lo, hi = int(row_ptr[r]), int(row_ptr[r + 1])
        keep = (edges[:, 1] == r) & (w != 0)
        np.testing.assert_array_equal(col[lo:hi].numpy(), edges[keep, 0])
        np.testing.assert_array_equal(wc[lo:hi].numpy(), w[keep])


@pytest.mark.parametrize("t_offset", [-4, 0, 7])
@pytest.mark.parametrize("t,n,f,w", [(16, 8, 4, 3), (5, 10, 6, 5),
                                     (24, 10, 6, 7), (9, 3, 2, 1)])
def test_m_product_matches_banded_ttm(t, n, f, w, t_offset):
    rng = np.random.default_rng(t * w + t_offset)
    x = rng.normal(size=(t, n, f)).astype(np.float32)
    got = mp_ops.m_product(torch.from_numpy(x), w, t_offset).numpy()
    oracle = np.asarray(jmp_ops.banded_ttm_ref(jnp.asarray(x), w, t_offset))
    np.testing.assert_allclose(got, oracle, rtol=MP_TOL, atol=MP_TOL)
    pallas = np.asarray(jmp.banded_ttm(jnp.asarray(x.reshape(t, -1)), w,
                                       t_offset, interpret=True)
                        ).reshape(x.shape)
    # rows whose band reaches before row 0 while t_offset > 0 read a
    # clamped tile in the Pallas kernel; callers slice them off
    keep = slice(w - 1, None) if t_offset > 0 else slice(None)
    np.testing.assert_allclose(got[keep], pallas[keep], rtol=MP_TOL,
                               atol=MP_TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_m_product_sliced_with_prefix_equals_full(use_pallas):
    rng = np.random.default_rng(3)
    t, n, f, w, s = 12, 6, 4, 4, 6
    x = torch.from_numpy(rng.normal(size=(t, n, f)).astype(np.float32))
    full = temporal.m_product(x, w)
    sl = temporal.m_product_with_prefix(x[s:], x[s - (w - 1):s], w, s)
    np.testing.assert_allclose(sl.numpy(), full[s:].numpy(), rtol=MP_TOL,
                               atol=MP_TOL)
    ref = jtemporal.m_product_with_prefix(
        jnp.asarray(x[s:].numpy()), jnp.asarray(x[s - (w - 1):s].numpy()),
        w, s, use_pallas=use_pallas)
    np.testing.assert_allclose(sl.numpy(), np.asarray(ref), rtol=MP_TOL,
                               atol=MP_TOL)


@pytest.mark.parametrize("t_offset", [-4, 0, 7])
def test_plain_m_product_matches_jax_plain_path(t_offset):
    """The port's M-product against the JAX package's plain
    cumulative-sum form on every row whose band lies at global steps >= 1:
    all rows for t_offset >= 0, rows [w - 1 - t_offset:] below it.  Before
    that the cumsum form also sums steps <= 0 and divides by
    min(w, g) <= 0; the prefix form slices those rows off, and at t = 0 its
    prefix is zeros."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(10, 5, 3)).astype(np.float32)
    w = 4
    got = temporal.m_product(torch.from_numpy(x), w, t_offset).numpy()
    want = np.asarray(jtemporal.m_product(jnp.asarray(x), w, t_offset))
    keep = slice(w - 1 - t_offset if t_offset < 0 else 0, None)
    np.testing.assert_allclose(got[keep], want[keep], rtol=MP_TOL,
                               atol=MP_TOL)
    assert np.isfinite(got).all()


def test_kernel_load_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spmm_ops.KERNEL.load()


def test_kernel_library_name_follows_source_and_flags():
    k = spmm_ops.KERNEL
    assert k.lib_path.parent == build.BUILD_DIR
    assert k.lib_path == spmm_ops.KERNEL.lib_path
    assert k.lib_path != mp_ops.KERNEL.lib_path
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
