"""The port's kernel wrappers held to the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version on the
CSR / band the CUDA kernel would get; the JAX side runs the Pallas kernel
in interpret mode and through its dense oracle.  The CUDA kernels
themselves are held to these plain versions on the card by
``chip_smoke.py``.  Tolerances are the reference's own:
segment SpMM 1e-4 (``tests/test_kernels.py:39``), M-product 1e-5 (``:85``),
flash decode 1e-4 in f32 and 2e-2 in bf16 (``:129``, ``:143``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import temporal as jtemporal
from repro.kernels.flash_decode import ops as jfd_ops
from repro.kernels.mproduct import mproduct as jmp
from repro.kernels.mproduct import ops as jmp_ops
from repro.kernels.segment_spmm import ops as jspmm_ops
from repro_torch.core import temporal
from repro_torch import kernels as kmod
from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.mproduct import ops as mp_ops
from repro_torch.kernels.segment_spmm import ops as spmm_ops

SPMM_TOL = 1e-4
MP_TOL = 1e-5
FD_TOL = 1e-4
FD_TOL_BF16 = 2e-2


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


def _decode_inputs(seed, b, hq, kvh, d, s, lens=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    clen = (rng.integers(1, s, size=(b,)) if lens is None
            else np.asarray(lens)).astype(np.int32)
    return q, k, v, clen


@pytest.mark.parametrize("b,hq,kvh,d,s,blk", [
    (2, 8, 2, 64, 1024, 256), (1, 4, 4, 128, 512, 128),
    (4, 16, 4, 64, 2048, 512), (2, 8, 8, 64, 256, 128)])
def test_flash_decode_matches_pallas_and_oracle(b, hq, kvh, d, s, blk):
    """The reference's own four shapes: the wrapper's plain version against
    the Pallas kernel (interpret mode) and its oracle."""
    q, k, v, clen = _decode_inputs(b * s, b, hq, kvh, d, s)
    got = fd_ops.decode_attention(*map(torch.from_numpy, (q, k, v, clen)))
    args = tuple(map(jnp.asarray, (q, k, v, clen)))
    pallas = jfd_ops.decode_attention(*args, kv_block=blk, interpret=True)
    for want in (pallas, jfd_ops.flash_decode_ref(*args)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FD_TOL, atol=FD_TOL)


def test_flash_decode_bf16_matches_pallas_and_oracle():
    q, k, v, _ = _decode_inputs(9, 2, 4, 2, 64, 512)
    clen = np.array([100, 500], np.int32)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    got = fd_ops.decode_attention(
        *[torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
          for a in bf], torch.from_numpy(clen))
    assert got.dtype == torch.bfloat16
    jlen = jnp.asarray(clen)
    for want in (jfd_ops.decode_attention(*bf, jlen, kv_block=128,
                                          interpret=True),
                 jfd_ops.flash_decode_ref(*bf, jlen)):
        np.testing.assert_allclose(got.to(torch.float32).numpy(),
                                   np.asarray(want, dtype=np.float32),
                                   rtol=FD_TOL_BF16, atol=FD_TOL_BF16)


@pytest.mark.parametrize("s,lens", [(700, [0, 1, 700, 350]),
                                    (4160, [4097, 1, 0, 9000]),
                                    (37, [37, 36, 2, 1])])
def test_flash_decode_ragged_s_and_edge_lengths(s, lens):
    """Against the oracle: S not a multiple of any KV block, cache_len 0
    (the uniform mean of V over all S rows, as the -1e30 mask gives),
    1, S and above S (clamped)."""
    q, k, v, clen = _decode_inputs(s, len(lens), 8, 2, 32, s, lens)
    got = fd_ops.decode_attention(*map(torch.from_numpy, (q, k, v, clen)))
    want = jfd_ops.flash_decode_ref(*map(jnp.asarray, (q, k, v, clen)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FD_TOL,
                               atol=FD_TOL)
    assert np.isfinite(got.numpy()).all()
    if 0 in lens:
        row = lens.index(0)
        mean_v = v[row].mean(axis=0)                   # (KVH, D)
        np.testing.assert_allclose(
            got.numpy()[row].reshape(2, 4, 32),
            np.broadcast_to(mean_v[:, None], (2, 4, 32)), rtol=FD_TOL,
            atol=FD_TOL)


@pytest.mark.parametrize("b,s,hq,kvh,d,want_bf16,want_f32", [
    # Yi-6B decode: 32 x 8 = 256 CTAs, one head group of 8 padded to 16
    (8, 4160, 32, 4, 128, (16, 8), (8, 8)),
    (8, 32768, 32, 4, 128, (16, 8), (8, 8)),         # decode_32k
    (1, 524288, 32, 4, 128, (16, 66), (8, 66)),      # long_500k: 264 CTAs
    (8, 4160, 36, 36, 64, (1, 1), (1, 1)),           # MiniCPM (G = 1)
    (8, 4160, 16, 16, 256, (1, 2), (1, 2)),          # Gemma (G = 1)
    (2, 100, 4, 2, 128, (16, 2), (8, 2)),            # G = 2; short cache
    (1, 64, 48, 2, 128, (16, 1), (8, 1)),            # G = 24: 2 or 3 groups
    (2, 1000, 16, 4, 64, (16, 16), (8, 16)),         # G = 4 at D 64
    (2, 700, 16, 2, 96, (16, 11), (8, 11)),          # D 96, padded to 128
    (4, 4160, 32, 4, 256, (8, 16), (8, 16)),         # D > 128: CUDA cores
])
def test_flash_decode_plan_fills_the_card_in_one_wave(b, s, hq, kvh, d,
                                                      want_bf16, want_f32):
    """The instance by type, G and D (tensor cores: bf16, G > 1,
    D <= 128), and splits that fill the card in one wave."""
    for bf16, want in ((True, want_bf16), (False, want_f32)):
        tile, splits = fd_ops.plan(b, s, hq, kvh, d, bf16, sm_count=132)
        assert (tile, splits) == want
        ctas = b * kvh * -(-(hq // kvh) // tile) * splits
        assert splits == 1 or ctas <= fd_ops.CTAS_PER_SM * 132
        assert ctas > 132 or splits == -(-s // fd_ops.MIN_ROWS_PER_SPLIT)


@pytest.mark.parametrize("d", [64, 96, 128])
def test_flash_decode_tc_instance_fits_two_ctas_per_sm(d):
    """The tensor-core instance's ring fits a CTA's 227 KB of shared
    memory, and two CTAs (each with the 1 KB the SM reserves) fit the
    SM's 228 KB, so ``plan``'s two CTAs per SM are resident at once."""
    smem = fd_ops.tc_smem_bytes(d)
    assert smem <= 232_448
    assert fd_ops.CTAS_PER_SM * (smem + 1024) <= 233_472
    assert fd_ops.tc_smem_bytes(128) == 3 * 2 * 64 * 136 * 2


def _tc_emulation(q, k, v, cache_len, splits, p_precision):
    """fp32 emulation of the tensor-core instance on bf16 inputs: exact
    bf16 products summed in fp32, scores in log2 units, a 64-row tile
    per online-softmax rescale, p rounded to bf16 or split hi + lo before
    the PV product, the splits merged, the output rounded to bf16."""
    qf, kf, vf = (t.to(torch.float64).to(torch.float32) for t in (q, k, v))
    b, hq, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = hq // kvh
    scale = np.float32(np.log2(np.e) / np.sqrt(d))
    out = torch.zeros((b, hq, d))
    for bi in range(b):
        n = int(cache_len[bi])
        none = n <= 0
        n = s if none else min(n, s)
        per = -(-n // splits)
        parts = []
        for sp in range(splits):
            lo, hi = min(sp * per, n), min(sp * per + per, n)
            m = torch.full((hq,), -1e30)
            l = torch.zeros(hq)
            acc = torch.zeros((hq, d))
            for t0 in range(lo, hi, 64):
                rows = slice(t0, min(t0 + 64, hi))
                kk = kf[bi, rows].repeat_interleave(g, dim=1)   # (r, hq, d)
                vv = vf[bi, rows].repeat_interleave(g, dim=1)
                sc = torch.einsum("hd,rhd->hr", qf[bi], kk) * scale
                if none:
                    sc = torch.full_like(sc, -1e30)
                mn = torch.maximum(m, sc.max(1).values)
                corr = torch.exp2(m - mn)
                p = torch.exp2(sc - mn[:, None])
                l = l * corr + p.sum(1)
                hi_p = p.to(torch.bfloat16).float()
                if p_precision == "bf16":
                    p_used = hi_p
                else:
                    p_used = hi_p + (p - hi_p).to(torch.bfloat16).float()
                acc = acc * corr[:, None] + torch.einsum("hr,rhd->hd",
                                                         p_used, vv)
                m = mn
            parts.append((m, l, acc))
        mx = torch.stack([p[0] for p in parts]).max(0).values
        wts = [torch.exp2(p[0] - mx) for p in parts]
        num = sum(p[2] * w[:, None] for p, w in zip(parts, wts))
        den = sum(p[1] * w for p, w in zip(parts, wts))
        out[bi] = num / den[:, None]
    return out.to(torch.bfloat16).float()


@pytest.mark.parametrize("b,hq,kvh,d,s,lens,splits", [
    (2, 16, 2, 128, 300, [300, 123], 3),
    (2, 8, 4, 64, 700, [1, 650], 4),
    (1, 32, 4, 128, 1500, [1500], 8),
    (2, 16, 2, 128, 200, [0, 200], 2),
])
def test_flash_decode_bf16_card_check_rehearsal(b, hq, kvh, d, s, lens,
                                                splits):
    """The card's bf16 check, rehearsed on the CPU: the tensor-core
    instance's arithmetic (p split hi + lo) stays within half of
    chip_smoke.py's limit (1e-2 x each batch row's max |plain fp32|, no
    absolute term), and so would p rounded to bf16; zeros fail it."""
    q, k, v, clen = _decode_inputs(d + s, b, hq, kvh, d, s, lens)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    cl = torch.from_numpy(clen)
    want = fd_ops.flash_decode_ref(qb.float(), kb.float(), vb.float(), cl)
    limit = 1e-2 * want.abs().flatten(1).amax(1)
    for precision in ("hi+lo", "bf16"):
        got = _tc_emulation(qb, kb, vb, cl, splits, precision)
        ratio = float(((got - want).abs().flatten(1).amax(1) / limit).max())
        assert ratio <= 0.5, (precision, ratio)
    assert float((want.abs().flatten(1).amax(1) / limit).min()) >= 10


def test_flash_decode_wrapper_refuses_other_devices():
    q = torch.zeros((1, 4, 32), device="meta")
    k = torch.zeros((1, 8, 2, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fd_ops.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32))


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
    assert len({kk.lib_path for kk in kmod.ALL}) == len(kmod.ALL) == 3
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
