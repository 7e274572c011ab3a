"""Hybrid partitioning (paper §6.5) in the port, on a 2-D grid of gloo
ranks, held to the JAX package's ``hybrid_forward`` and ``hybrid_spmm``
over host meshes of the same shape.

One pool of 4 rank processes per module (``pool``) runs every case on the
CPU and writes each rank's results to ``tmp_path``; the tests below read
them and compare with the JAX package, computed here in the parent.  The
ranks are started with the spawn method and import this module for its
rank program, so the module imports no JAX at its top: the JAX side is
the ``jx`` fixture's.  Sizes are ``tests/test_hybrid.py``'s (T = 8,
N = 32, window 3) and ``tests/test_partitioning.py``'s hybrid SpMM (n =
64, 512 edges, F = 8).

* ``make_grid``: rank r at data index r // Pm, model index r % Pm, its
  data group the grid column and its model group the grid row;
* ``hybrid_forward`` on 2 x 2, 1 x 4 and 4 x 1 grids against the JAX
  ``hybrid_forward`` on the same host mesh (atol 1e-5,
  ``tests/test_hybrid.py``) and the single-device forward, tmgcn and
  cdgcn, with the aggregate counted through the ``segment_spmm`` wrapper
  (L T/Pd calls and T/Pd CSR builds a rank); EvolveGCN refused, as the
  reference fails on it;
* ``hybrid_spmm`` on a 1 x 4 grid against the dense product (atol 1e-4,
  ``tests/test_partitioning.py``), one wrapper call a rank;
* ``partition_edges_for_hybrid`` byte-identical to the reference's, and the
  rectangular ``segment_spmm_csr_ref`` against a dense product, with the
  square case unchanged.
"""

import datetime
import pickle
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import convert
from repro_torch.core import hybrid
from repro_torch.core import models as tm
from repro_torch.core import partition
from repro_torch.dist import sharding
from repro_torch.kernels.segment_spmm import ops as spmm_ops
from repro_torch.kernels.segment_spmm import ref as spmm_ref

P = 4
T, N, W = 8, 32, 3
GRIDS = [(2, 2), (1, 4), (4, 1)]
MODELS = ["tmgcn", "cdgcn"]
SPMM_N, SPMM_E, SPMM_F = 64, 512, 8
POOL_DEADLINE_S = 120


# ------------------------------------------------------- the rank program ---

def _cfg(model):
    return tm.DynGNNConfig(model=model, num_nodes=N, num_steps=T, window=W,
                           checkpoint_blocks=1)


def _counting():
    """Patch the segment_spmm plain version with a counter -> (calls,
    restore)."""
    calls = [0]
    saved = spmm_ops.segment_spmm_csr_ref

    def counted(*a):
        calls[0] += 1
        return saved(*a)

    spmm_ops.segment_spmm_csr_ref = counted

    def restore():
        spmm_ops.segment_spmm_csr_ref = saved

    return calls, restore


def _hybrid_case(grid, model, inputs):
    e_h, w_h = hybrid.partition_edges_for_hybrid(
        inputs["edges"], inputs["ew"], inputs["mask"], N, pm=grid.pm,
        max_local_edges=inputs["edges"].shape[1])
    frames, edges, ew = hybrid.local_blocks(
        grid, torch.from_numpy(inputs["frames"]), torch.from_numpy(e_h),
        torch.from_numpy(w_h))
    params = convert.params_from_jax(inputs["params"][model])
    fwd = hybrid.hybrid_forward(_cfg(model), grid)
    calls, restore = _counting()
    spmm_ops.csr_builds = 0
    try:
        z = fwd(params, frames, edges, ew)
    finally:
        restore()
    return {"z": z.numpy(), "spmm_calls": calls[0],
            "csr_builds": spmm_ops.csr_builds}


def _spmm_case(grid, inputs):
    e_loc = SPMM_E // grid.pm
    sl = slice(grid.model_index * e_loc, (grid.model_index + 1) * e_loc)
    calls, restore = _counting()
    try:
        out = partition.hybrid_spmm(
            torch.from_numpy(inputs["x"]),
            torch.from_numpy(inputs["spmm_edges"][sl]),
            torch.from_numpy(inputs["spmm_w"][sl]), SPMM_N, grid.model)
    finally:
        restore()
    return {"out": out.numpy(), "spmm_calls": calls[0]}


def _rank_main(rank, store_path, out_dir, inputs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, P),
                            rank=rank, world_size=P,
                            timeout=datetime.timedelta(seconds=60))
    try:
        res = {"layout": {}, "hybrid": {}}
        for pd, pm in GRIDS:
            grid = sharding.make_grid(pd, pm)
            res["layout"][(pd, pm)] = (
                grid.data_index, grid.model_index,
                dist.get_process_group_ranks(grid.data),
                dist.get_process_group_ranks(grid.model))
            for model in MODELS:
                res["hybrid"][(pd, pm, model)] = _hybrid_case(grid, model,
                                                              inputs)
        res["spmm"] = _spmm_case(sharding.make_grid(1, 4), inputs)
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, nprocs: int, args: tuple, deadline_s: float) -> None:
    """Start ``nprocs`` spawned ranks of ``fn(rank, *args)`` and join them
    by ``deadline_s``; a rank's failure, or the deadline, kills the rest
    and fails."""
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=max(end - time.monotonic(), 0.0)):
            if time.monotonic() >= end:
                raise TimeoutError(f"{nprocs} ranks still running after "
                                   f"{deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


# ------------------------------------------------------------ fixtures ------

@pytest.fixture(scope="module")
def jx():
    """The JAX package, here in the parent only."""
    import jax
    import jax.numpy as jnp

    from repro.core import dtdg as jdtdg
    from repro.core import hybrid as jhybrid
    from repro.core import models as jm
    from repro.core import partition as jpart
    from repro.graph import generate as jgen
    from repro.graph import segment as jseg
    from repro.launch.mesh import make_host_mesh
    return types.SimpleNamespace(**locals())


@pytest.fixture(scope="module")
def jbatch(jx):
    """``tests/test_hybrid.py``'s batch and each model's PRNGKey(0)
    parameters (numpy trees)."""
    snaps = jx.jgen.evolving_dynamic_graph(N, T, density=2.0, churn=0.1,
                                           seed=0)
    frames = np.stack([jx.jgen.degree_features(s, N) for s in snaps])
    batch = jx.jdtdg.build_batch(snaps, frames, N)
    params = {m: jx.jax.tree.map(np.asarray, jx.jm.init_params(
        jx.jax.random.PRNGKey(0), _jcfg(jx, m))) for m in MODELS}
    return batch, params


@pytest.fixture(scope="module")
def inputs(jbatch):
    batch, params = jbatch
    rng = np.random.default_rng(0)
    spmm_edges = rng.integers(0, SPMM_N, size=(SPMM_E, 2)).astype(np.int32)
    spmm_w = rng.normal(size=(SPMM_E,)).astype(np.float32)
    x = rng.normal(size=(SPMM_N, SPMM_F)).astype(np.float32)
    return {"frames": np.asarray(batch.frames),
            "edges": np.asarray(batch.edges),
            "ew": np.asarray(batch.edge_weights),
            "mask": np.asarray(batch.edge_mask), "params": params,
            "spmm_edges": spmm_edges, "spmm_w": spmm_w, "x": x}


@pytest.fixture(scope="module")
def pool(tmp_path_factory, inputs):
    """Every case on 4 gloo ranks -> [rank 0's results, ..., rank 3's]."""
    d = tmp_path_factory.mktemp("hybrid")
    run_ranks(_rank_main, P, (str(d / "store"), str(d), inputs),
              POOL_DEADLINE_S)
    out = []
    for r in range(P):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _jcfg(jx, model):
    return jx.jm.DynGNNConfig(model=model, num_nodes=N, num_steps=T,
                              window=W, checkpoint_blocks=1)


def _assemble(pool, pd, pm, model):
    """The ranks' (T/Pd, N/Pm, F') blocks -> the global (T, N, F')."""
    rows = [np.concatenate([pool[d * pm + m]["hybrid"][(pd, pm, model)]["z"]
                            for m in range(pm)], axis=1)
            for d in range(pd)]
    return np.concatenate(rows, axis=0)


# ------------------------------------------------------------- the grid -----

@pytest.mark.parametrize("pd,pm", GRIDS)
def test_grid_places_ranks_as_the_host_mesh(pool, pd, pm):
    """Rank r at (r // Pm, r % Pm): its data group is its grid column,
    its model group its grid row, in rank order."""
    for r, res in enumerate(pool):
        d, m, column, row = res["layout"][(pd, pm)]
        assert (d, m) == (r // pm, r % pm)
        assert column == [dd * pm + m for dd in range(pd)]
        assert row == [d * pm + mm for mm in range(pm)]


def test_make_grid_refuses_a_grid_that_is_not_the_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="2 x 3 grid needs 6 ranks"):
            sharding.make_grid(2, 3)
        grid = sharding.make_grid(1, 1)
        assert grid.data is grid.model is dist.group.WORLD
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- hybrid forward -----

@pytest.mark.parametrize("pd,pm", GRIDS)
@pytest.mark.parametrize("model", MODELS)
def test_hybrid_forward_matches_jax(pool, jx, jbatch, pd, pm, model):
    """The ranks' blocks of Z within 1e-5 of the JAX ``hybrid_forward`` on
    a ``data=Pd, model=Pm`` host mesh and of the JAX single-device
    forward (``tests/test_hybrid.py:37``)."""
    batch, params = jbatch
    cfg = _jcfg(jx, model)
    jparams = jx.jax.tree.map(jx.jnp.asarray, params[model])
    e_h, w_h = jx.jhybrid.partition_edges_for_hybrid(
        batch.edges, batch.edge_weights, batch.edge_mask, N, pm=pm,
        max_local_edges=batch.edges.shape[1])
    fwd = jx.jhybrid.hybrid_forward(cfg, jx.make_host_mesh(data=pd,
                                                           model=pm))
    want = np.asarray(jx.jax.jit(fwd)(jparams, batch.frames,
                                      jx.jnp.asarray(e_h),
                                      jx.jnp.asarray(w_h)))
    got = _assemble(pool, pd, pm, model)
    assert got.shape == want.shape == (T, N, 6)
    np.testing.assert_allclose(got, want, atol=1e-5)
    z_ref = np.asarray(jx.jm.forward(cfg, jparams, batch))
    np.testing.assert_allclose(got, z_ref, atol=1e-5)


@pytest.mark.parametrize("pd,pm", GRIDS)
def test_the_aggregate_runs_through_the_kernel_wrapper(pool, pd, pm):
    """A rank's forward: one rectangular CSR per local snapshot, shared by
    the layers, and one ``segment_spmm`` call a layer and snapshot."""
    for res in pool:
        for model in MODELS:
            got = res["hybrid"][(pd, pm, model)]
            assert got["csr_builds"] == T // pd
            assert got["spmm_calls"] == 2 * (T // pd)


def test_evolvegcn_is_refused_as_the_reference_fails_on_it(jx, jbatch):
    """The reference's ``hybrid_forward`` reads each layer's ``gcn``
    parameters, which EvolveGCN has not (a KeyError); the port refuses it
    with a ValueError naming that limit, before any collective."""
    batch, _ = jbatch
    cfg = jx.jm.DynGNNConfig(model="evolvegcn", num_nodes=N, num_steps=T,
                             window=W)
    jparams = jx.jm.init_params(jx.jax.random.PRNGKey(0), cfg)
    e_h, w_h = jx.jhybrid.partition_edges_for_hybrid(
        batch.edges, batch.edge_weights, batch.edge_mask, N, pm=2,
        max_local_edges=batch.edges.shape[1])
    fwd = jx.jhybrid.hybrid_forward(cfg, jx.make_host_mesh(data=2, model=2))
    with pytest.raises(KeyError, match="gcn"):
        fwd(jparams, batch.frames, jx.jnp.asarray(e_h), jx.jnp.asarray(w_h))
    grid = sharding.Grid(pd=2, pm=2, rank=0, data=None, model=None)
    with pytest.raises(ValueError, match="repro.core.hybrid.hybrid_forward "
                                         "reads each layer's 'gcn'"):
        hybrid.hybrid_forward(tm.DynGNNConfig(model="evolvegcn"), grid)


# ----------------------------------------------------------- hybrid spmm ----

def test_hybrid_spmm_matches_dense(pool, jx, inputs):
    """Each rank of a 1 x 4 grid aggregates its quarter of the edges
    through the wrapper (one call) and the all-reduce over the model row
    completes the product on every rank: within 1e-4 of the dense product
    (``tests/test_partitioning.py:142``)."""
    want = np.asarray(jx.jseg.spmm(
        jx.jnp.asarray(inputs["x"]), jx.jnp.asarray(inputs["spmm_edges"]),
        jx.jnp.asarray(inputs["spmm_w"]), SPMM_N))
    dense = np.zeros((SPMM_N, SPMM_N), np.float64)
    np.add.at(dense, (inputs["spmm_edges"][:, 1], inputs["spmm_edges"][:, 0]),
              inputs["spmm_w"])
    for res in pool:
        np.testing.assert_allclose(res["spmm"]["out"], want, atol=1e-4)
        np.testing.assert_allclose(res["spmm"]["out"], dense @ inputs["x"],
                                   atol=1e-4)
        assert res["spmm"]["spmm_calls"] == 1
        np.testing.assert_array_equal(res["spmm"]["out"],
                                      pool[0]["spmm"]["out"])


# ------------------------------------------------- copies and the kernel ----

@pytest.mark.parametrize("pm", [1, 2, 4])
def test_partition_edges_for_hybrid_is_the_reference(jx, jbatch, pm):
    batch, _ = jbatch
    args = (np.asarray(batch.edges), np.asarray(batch.edge_weights),
            np.asarray(batch.edge_mask), N)
    for cap in (batch.edges.shape[1], 7):       # 7: shards truncated
        want = jx.jhybrid.partition_edges_for_hybrid(*args, pm=pm,
                                                     max_local_edges=cap)
        got = hybrid.partition_edges_for_hybrid(*args, pm=pm,
                                                max_local_edges=cap)
        for a, b in zip(got, want, strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n_dst,n_src", [(16, 64), (64, 16), (40, 40)])
def test_rectangular_csr_matches_a_dense_product(n_dst, n_src):
    """``build_csr(edges, w, n_dst)`` with sources among n_src rows: the
    plain version returns n_dst rows equal to the dense (n_dst, n_src)
    product; zero-weight pad lanes land in the dump row."""
    rng = np.random.default_rng(n_dst * 1000 + n_src)
    e = 300
    edges = np.stack([rng.integers(0, n_src, e),
                      rng.integers(0, n_dst, e)], axis=1).astype(np.int32)
    w = rng.uniform(0.5, 1.0, e).astype(np.float32)
    w[::7] = 0.0                                  # padded lanes
    edges[::7] = 0
    x = rng.normal(size=(n_src, 5)).astype(np.float32)
    csr = spmm_ops.build_csr(torch.from_numpy(edges), torch.from_numpy(w),
                             n_dst)
    assert csr[0].shape == (n_dst + 1,)
    got = spmm_ops.segment_spmm_csr(torch.from_numpy(x), *csr)
    assert got.shape == (n_dst, 5)
    dense = np.zeros((n_dst, n_src), np.float64)
    np.add.at(dense, (edges[:, 1], edges[:, 0]), w)
    np.testing.assert_allclose(got.numpy(), dense @ x, atol=1e-5)


def test_square_case_is_the_former_arithmetic():
    """With as many rows as x, the plain version is the former
    ``index_add_`` over x's rows, bit for bit."""
    rng = np.random.default_rng(3)
    n, e = 50, 400
    edges = torch.from_numpy(rng.integers(0, n, (e, 2)).astype(np.int32))
    w = torch.from_numpy(rng.normal(size=e).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32))
    row_ptr, col, wc = spmm_ops.build_csr(edges, w, n)
    nnz = int(row_ptr[-1])
    rows = torch.repeat_interleave(torch.arange(n),
                                   (row_ptr[1:] - row_ptr[:-1]).long())
    want = torch.zeros((n, 6)).index_add_(0, rows,
                                          x[col[:nnz].long()] * wc[:nnz, None])
    assert torch.equal(spmm_ref.segment_spmm_csr_ref(x, row_ptr, col, wc),
                       want)
    assert torch.equal(spmm_ops.segment_spmm(x, edges, w, n), want)
