"""Out-of-core sampled training (``repro_torch.hoststore``) in the port, on 4
gloo ranks, held to the JAX package's ``repro.hoststore`` on 4 host
devices.

One pool of 4 rank processes per module (``pool``) runs every training
case on the CPU and writes each rank's results to ``tmp_path``; the tests
below read them and compare with the JAX package, computed here in the
parent.  The ranks are started with the spawn method and import this
module for its rank program, so the module imports no JAX at its top: the
JAX side is the ``jx`` fixture's.  Sizes are ``tests/test_hoststore.py``'s
(N = 48, T = 16, nb 2, window 3: rounds of 8 snapshots, 2 a rank at P =
4), its Engine's N = 50 (not a multiple of 4: the table pads, not N).

* the copied host numpy — the sampler, the store, ``draw_seeds``,
  ``sample_round``, the spec's resolution and the budget numbers — equal
  to the reference's, byte for byte where they make arrays;
* carry gather / scatter round trips for all three models;
* ``train_sampled`` on 4 ranks against the JAX ``train_sampled`` on 4 host
  devices (losses rtol 1e-5, parameters atol 1e-6,
  ``tests/test_hoststore.py``), with full fanout (all three models) and
  truncated fanout; full fanout against the port's own ``streamed_mesh``
  run; the ranks' carry stores byte-identical after every round; the
  prefetch thread on and off identical;
* ``Engine(mode="sampled")`` against the JAX Engine; the budget gate: the
  full-graph schedules refuse a budget the sampled one fits;
* launch and CSR-build counts a round on the plain versions, at P = 1
  and 4; the plan's rules; and the ``torchrun`` launcher on 2 ranks.
"""

import datetime
import os
import pickle
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import convert
from repro_torch import hoststore as hs
from repro_torch.core import models as tm
from repro_torch.data import dyngnn as data
from repro_torch.graph import sampler as smp
from repro_torch.kernels.mproduct import ops as mp_ops
from repro_torch.kernels.segment_spmm import ops as spmm_ops
from repro_torch.run import (Engine, ExecutionPlan, RunConfig, SamplingSpec,
                             SyntheticTrace)
from repro_torch.stream import distributed as sd

ROOT = Path(__file__).resolve().parents[1]
P = 4
N, T, NB, W = 48, 16, 2, 3
WIN = T // NB
EPOCHS = 2
ENGINE_N = 50
MODELS = ["tmgcn", "cdgcn", "evolvegcn"]
SMOOTH = {"tmgcn": "mproduct", "evolvegcn": "edgelife", "cdgcn": "none"}
TRUNC = {"batch_nodes": 24, "fanouts": (4, 4), "seed": 0}
ENGINE_SPEC = {"batch_nodes": 16, "fanouts": (4, 4), "seed": 2}
BUDGET_SPEC = {"batch_nodes": 12, "fanouts": (3, 3), "seed": 0,
               "table_pad": 24, "max_edges": 128}
POOL_DEADLINE_S = 150


# ------------------------------------------------------- the rank program ---

def _silent(_msg):
    return None


def _ds(model, seed=0):
    """``tests/test_hoststore.py::_ds`` in the port (its numpy copies)."""
    ds = data.synthetic_dataset(N, T, density=2.0, churn=0.1,
                                smoothing_mode=SMOOTH[model], window=W,
                                seed=seed)
    cfg = tm.DynGNNConfig(model=model, num_nodes=N, num_steps=T, window=W,
                          checkpoint_blocks=NB)
    return cfg, ds


def _store(ds):
    pipe = data.DTDGPipeline(ds, nb=NB, device="cpu")
    return pipe, hs.TemporalCSRStore.from_stream(pipe.host_stream(), N)


def _train(group, jparams, model, spec_kw=None, record=False, **kw):
    """``train_sampled`` on this rank: full fanout unless ``spec_kw``;
    with ``record``, a copy of the rank's carry store after every
    round."""
    cfg, ds = _ds(model)
    _, store = _store(ds)
    deg = store.max_in_degree()
    spec = hs.SamplingSpec(**(spec_kw or {"batch_nodes": N,
                                          "fanouts": (deg, deg)}))
    params = convert.params_from_jax(jparams[model])
    carry_store = hs.HostCarryStore(cfg, params)
    after = []
    if record:
        scatter = carry_store.scatter

        def recording(node_ids, new):
            scatter(node_ids, new)
            after.append([a.copy() for layer in carry_store.arrays()
                          for a in layer])

        carry_store.scatter = recording
    st = hs.train_sampled(cfg, store, ds.frames, ds.labels, spec=spec,
                          mesh=group, block_size=WIN, num_epochs=EPOCHS,
                          params=params, carry_store=carry_store,
                          device="cpu", **kw)
    rep = st.report
    return {"losses": st.losses, "params": convert.params_to_numpy(st.params),
            "stores": after, "rounds": rep.rounds,
            "dropped": (rep.dropped_nodes, rep.dropped_edges),
            "staged_bytes": rep.staged_bytes,
            "sampled_edges": rep.sampled_edges}


def _case_train(rank, group, jparams):
    out = {m: _train(group, jparams, m, record=True) for m in MODELS}
    for m in ("tmgcn", "cdgcn"):
        out[f"{m}-trunc"] = _train(group, jparams, m, TRUNC, record=True)
    out["cdgcn-trunc-sync"] = _train(group, jparams, "cdgcn", TRUNC,
                                     overlap=False)
    for m in MODELS:
        cfg, ds = _ds(m)
        pipe = data.DTDGPipeline(ds, nb=NB, device="cpu")
        st = sd.train_distributed_streamed(
            cfg, ds.snapshots, ds.values, ds.frames, ds.labels, mesh=group,
            block_size=WIN, num_epochs=EPOCHS, stats=pipe.stream_stats,
            max_edges=pipe.max_edges,
            params=convert.params_from_jax(jparams[m]), device="cpu")
        out[f"{m}-streamed_mesh"] = {
            "losses": st.losses, "params": convert.params_to_numpy(st.params)}
    return out


def _engine_cfg(n=ENGINE_N):
    return tm.DynGNNConfig(model="cdgcn", num_nodes=n, num_steps=T,
                           checkpoint_blocks=NB)


def _case_engine(rank, group, jparams):
    trace = SyntheticTrace(num_nodes=ENGINE_N, num_steps=T, density=2.0,
                           seed=1)
    eng = Engine(RunConfig(model=_engine_cfg(), data=trace,
                           plan=ExecutionPlan(
                               mode="sampled", shards=P, num_epochs=EPOCHS,
                               sampling=SamplingSpec(**ENGINE_SPEC)),
                           log_fn=_silent),
                 params=convert.params_from_jax(jparams["engine"]),
                 device="cpu")
    res = eng.fit()
    rep = res.sample_report
    return {"losses": res.losses, "num_nodes": eng.resolve().cfg.num_nodes,
            "rounds": rep.rounds, "table_fill_max": rep.table_fill_max,
            "budget_report": res.budget_report, "step": res.state.step,
            "params": convert.params_to_numpy(res.state.params)}


def _case_budget(rank, group, jparams):
    """A budget of exactly one sampled round: the full-graph schedules
    refuse it (the single-device ones on a one-rank group's rank, which
    they do not use), the sampled schedule fits and trains."""
    data_src = SyntheticTrace(num_nodes=N, num_steps=T, density=2.0, seed=3)
    cfg = tm.DynGNNConfig(model="cdgcn", num_nodes=N, num_steps=T,
                          checkpoint_blocks=NB)
    spec = SamplingSpec(**BUDGET_SPEC)
    budget = hs.sampled_round_bytes(spec.resolve(N, WIN, P), win=WIN,
                                    num_shards=P, feat_dim=2)
    refused = {}
    for mode, shards in (("eager", 1), ("streamed", 1),
                         ("streamed_mesh", P)):
        plan = ExecutionPlan(mode=mode, shards=shards,
                             device_budget_bytes=budget)
        try:
            Engine(RunConfig(model=cfg, data=data_src, plan=plan,
                             log_fn=_silent), device="cpu").fit()
            refused[mode] = None
        except hs.DeviceBudgetError as e:
            refused[mode] = (e.mode, e.required, e.budget)
    plan = ExecutionPlan(mode="sampled", shards=P, sampling=spec,
                         device_budget_bytes=budget)
    res = Engine(RunConfig(model=cfg, data=data_src, plan=plan,
                           log_fn=_silent), device="cpu").fit()
    return {"budget": budget, "refused": refused,
            "budget_report": res.budget_report, "losses": res.losses,
            "rounds": res.sample_report.rounds,
            "staged_bytes": res.sample_report.staged_bytes}


def _case_launches(rank, groups, jparams):
    """Kernel launches (their plain versions, reached through the same
    wrappers) and CSR builds of one epoch of full-fanout TM-GCN rounds,
    on a one-rank group and on the 4 ranks."""
    calls = {"spmm": 0, "ttm": 0, "ttm_t": 0}
    patched = [(spmm_ops, "segment_spmm_csr_ref", "spmm"),
               (mp_ops, "banded_ttm_ref", "ttm"),
               (mp_ops, "banded_ttm_t_ref", "ttm_t")]
    saved = [getattr(mod, name) for mod, name, _ in patched]

    def counted(key, fn):
        def call(*a):
            calls[key] += 1
            return fn(*a)
        return call

    for (mod, name, key), fn in zip(patched, saved, strict=True):
        setattr(mod, name, counted(key, fn))
    out = {}
    try:
        cfg, ds = _ds("tmgcn")
        _, store = _store(ds)
        deg = store.max_in_degree()
        spec = hs.SamplingSpec(batch_nodes=N, fanouts=(deg, deg))
        for label, group in groups.items():
            for key in calls:
                calls[key] = 0
            spmm_ops.csr_builds = 0
            hs.train_sampled(cfg, store, ds.frames, ds.labels, spec=spec,
                             mesh=group, block_size=WIN,
                             params=convert.params_from_jax(
                                 jparams["tmgcn"]), device="cpu")
            out[label] = {"per_round": {k: v / NB for k, v in calls.items()},
                          "csr_builds": spmm_ops.csr_builds / NB}
    finally:
        for (mod, name, _), fn in zip(patched, saved, strict=True):
            setattr(mod, name, fn)
    return out


def _rank_main(rank, store_path, out_dir, jparams):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, P),
                            rank=rank, world_size=P,
                            timeout=datetime.timedelta(seconds=60))
    try:
        world = dist.group.WORLD
        singles = [dist.new_group([r]) for r in range(P)]
        res = {"train": _case_train(rank, world, jparams),
               "engine": _case_engine(rank, world, jparams),
               "budget": _case_budget(rank, world, jparams),
               "launches": _case_launches(
                   rank, {"P1": singles[rank], "P4": world}, jparams)}
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

    from repro import hoststore as jhs
    from repro.core import models as jm
    from repro.data import dyngnn as jdata
    from repro.graph import sampler as jsmp
    from repro.launch.mesh import make_host_mesh
    from repro.run import Engine as JEngine
    from repro.run import ExecutionPlan as JPlan
    from repro.run import RunConfig as JRunConfig
    from repro.run import SamplingSpec as JSpec
    from repro.run import SyntheticTrace as JTrace
    return types.SimpleNamespace(**locals())


def _jcfg(jx, model, n=N):
    return jx.jm.DynGNNConfig(model=model, num_nodes=n, num_steps=T,
                              window=W, checkpoint_blocks=NB)


def _jds(jx, model):
    ds = jx.jdata.synthetic_dataset(N, T, density=2.0, churn=0.1,
                                    smoothing_mode=SMOOTH[model], window=W,
                                    seed=0)
    return _jcfg(jx, model), ds


def _jstore(jx, ds):
    pipe = jx.jdata.DTDGPipeline(ds, nb=NB)
    return jx.jhs.TemporalCSRStore.from_stream(pipe.host_stream(), N)


@pytest.fixture(scope="module")
def jparams(jx):
    """Each model's JAX parameters (``PRNGKey(0)``, what the JAX trainer
    and Engine draw from seed 0) as numpy trees; "engine": CD-GCN's at
    the Engine's N (the parameters do not depend on N)."""
    out = {m: jx.jax.tree.map(np.asarray, jx.jm.init_params(
        jx.jax.random.PRNGKey(0), _jcfg(jx, m))) for m in MODELS}
    out["engine"] = out["cdgcn"]
    return out


@pytest.fixture(scope="module")
def pool(tmp_path_factory, jparams):
    """Every case on 4 gloo ranks -> [rank 0's results, ..., rank 3's]."""
    d = tmp_path_factory.mktemp("hoststore")
    run_ranks(_rank_main, P, (str(d / "store"), str(d), jparams),
              POOL_DEADLINE_S)
    out = []
    for r in range(P):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def jruns(jx):
    """The JAX ``train_sampled`` on 4 host devices: full fanout for every
    model, truncated fanout for tmgcn and cdgcn."""
    mesh = jx.make_host_mesh(data=P, model=1)
    out = {}
    for model in MODELS:
        cfg, ds = _jds(jx, model)
        store = _jstore(jx, ds)
        deg = store.max_in_degree()
        for key, spec in ((model, jx.jhs.SamplingSpec(
                batch_nodes=N, fanouts=(deg, deg), seed=0)),
                (f"{model}-trunc", jx.jhs.SamplingSpec(**TRUNC))):
            if key == "evolvegcn-trunc":
                continue
            out[key] = jx.jhs.train_sampled(
                cfg, store, np.asarray(ds.frames), np.asarray(ds.labels),
                spec=spec, mesh=mesh, block_size=WIN, num_epochs=EPOCHS)
    return out


def _named(jx, tree) -> dict:
    return {jx.jax.tree_util.keystr(k, simple=True, separator="."):
            np.asarray(v)
            for k, v in jx.jax.tree_util.tree_flatten_with_path(tree)[0]}


def _same_on_every_rank(pool, key):
    first = pool[0]["train"][key]
    for r in pool[1:]:
        assert r["train"][key]["losses"] == first["losses"]
        for k, v in r["train"][key]["params"].items():
            np.testing.assert_array_equal(v, first["params"][k], err_msg=k)
    return first


def _assert_arrays_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ------------------------------------------------ the copied host numpy -----

@pytest.mark.parametrize("fanouts", [(3, 3), (10, 10), (1,), (2, 5, 2)])
def test_sampler_is_the_reference(jx, fanouts):
    rng = np.random.default_rng(len(fanouts) * 7 + fanouts[0])
    n = 200
    edges = rng.integers(0, n, size=(900, 2))
    g = smp.CSRGraph.from_edges(edges, n)
    jg = jx.jsmp.CSRGraph.from_edges(edges, n)
    _assert_arrays_equal(g.indptr, jg.indptr)
    _assert_arrays_equal(g.indices, jg.indices)
    seeds = np.sort(rng.choice(n, size=20, replace=False))
    got = smp.sample_neighbors(g, seeds, list(fanouts),
                               np.random.default_rng(5))
    want = jx.jsmp.sample_neighbors(jg, seeds, list(fanouts),
                                    np.random.default_rng(5))
    _assert_arrays_equal(got.node_ids, want.node_ids)
    _assert_arrays_equal(got.node_mask, want.node_mask)
    assert got.num_seeds == want.num_seeds
    assert len(got.blocks) == len(want.blocks) == len(fanouts)
    for a, b in zip(got.blocks, want.blocks, strict=True):
        for f in ("edges", "edge_mask", "edge_pos"):
            _assert_arrays_equal(getattr(a, f), getattr(b, f))
    for a, b in zip(smp.flat_edges(got), jx.jsmp.flat_edges(want),
                    strict=True):
        _assert_arrays_equal(a, b)


@pytest.mark.parametrize("model,block", [("tmgcn", WIN), ("cdgcn", WIN),
                                         ("evolvegcn", WIN),
                                         ("cdgcn", 1)])
def test_store_is_the_reference(jx, model, block):
    """The store ingests the port's own encoder items and holds the
    reference's CSR, values, edges, nbytes and max in-degree exactly."""
    _, ds = _ds(model)
    _, jds = _jds(jx, model)
    got = hs.TemporalCSRStore.from_snapshots(ds.snapshots, ds.values, N,
                                             block_size=block)
    want = jx.jhs.TemporalCSRStore.from_snapshots(jds.snapshots, jds.values,
                                                  N, block_size=block)
    assert got.num_steps == want.num_steps == T
    for t in range(T):
        _assert_arrays_equal(got.csr(t).indptr, want.csr(t).indptr)
        _assert_arrays_equal(got.csr(t).indices, want.csr(t).indices)
        _assert_arrays_equal(got.values_csr(t), want.values_csr(t))
        _assert_arrays_equal(got.edges(t), want.edges(t))
    assert got.nbytes == want.nbytes
    assert got.max_in_degree() == want.max_in_degree()
    if block == WIN:        # the pipeline's own items: the same store
        via_pipe = _store(ds)[1]
        for t in range(T):
            _assert_arrays_equal(via_pipe.csr(t).indices,
                                 got.csr(t).indices)


def test_store_rejects_delta_first():
    from repro_torch.stream import encoder as enc
    _, ds = _ds("cdgcn")
    items = list(enc.iter_encode_stream(
        ds.snapshots, ds.values, N, enc.padded_max_edges(ds.snapshots),
        WIN, None))
    with pytest.raises(ValueError, match="full sync"):
        hs.TemporalCSRStore(N).ingest(items[1])


def test_draw_seeds_is_the_reference(jx):
    for args in ((10, 10, 0, 0, 0), (10, 99, 0, 0, 0), (100, 10, 1, 0, 0),
                 (100, 10, 1, 0, 1), (755_200, 188_800, 0, 1, 3)):
        _assert_arrays_equal(hs.draw_seeds(*args), jx.jhs.draw_seeds(*args))


@pytest.mark.parametrize("spec_kw,r,epoch", [
    ({"batch_nodes": 12, "fanouts": (3, 3), "seed": 5}, 1, 0),
    ({"batch_nodes": 8, "fanouts": (8, 8), "seed": 0, "table_pad": 12,
      "max_edges": 16}, 0, 0),
    ({"batch_nodes": N, "fanouts": (50, 50), "seed": 0}, 1, 1)])
def test_sample_round_is_the_reference(jx, spec_kw, r, epoch):
    """Every array of a round — the table, frames, labels, edges, mask,
    values — and its counters equal the reference's, with 1 and 4 worker
    threads, through budgets that drop lanes too."""
    _, ds = _ds("cdgcn")
    _, jds = _jds(jx, "cdgcn")
    store = hs.TemporalCSRStore.from_snapshots(ds.snapshots, ds.values, N,
                                               block_size=WIN)
    jstore = jx.jhs.TemporalCSRStore.from_snapshots(
        jds.snapshots, jds.values, N, block_size=WIN)
    spec, jspec = hs.SamplingSpec(**spec_kw), jx.jhs.SamplingSpec(**spec_kw)
    resolved = spec.resolve(N, WIN, 4)
    assert resolved == spec.resolve(N, WIN, 4)
    assert vars(resolved) == vars(jspec.resolve(N, WIN, 4))
    with ThreadPoolExecutor(max_workers=2) as pool:
        want = jx.jhs.sample_round(jstore, np.asarray(jds.frames),
                                   np.asarray(jds.labels), jspec,
                                   jspec.resolve(N, WIN, 4), WIN, r, epoch,
                                   pool)
    for workers in (1, 4):
        with ThreadPoolExecutor(max_workers=workers) as pool:
            got = hs.sample_round(store, ds.frames, ds.labels, spec,
                                  resolved, WIN, r, epoch, pool)
        for f in ("node_ids", "frames", "labels", "edges", "mask",
                  "values"):
            _assert_arrays_equal(getattr(got, f), getattr(want, f))
        for f in ("r", "t0", "sampled_edges", "dropped_nodes",
                  "dropped_edges"):
            assert getattr(got, f) == getattr(want, f), f


def test_stream_rounds_sampled_in_processes_are_the_reference(jx):
    """``SampledSliceStream.rounds`` expands each round's steps in its
    spawned worker processes: every round of two epochs equals the
    reference's ``sample_round`` (threads) array for array, and
    ``close`` stops the workers."""
    _, ds = _ds("cdgcn")
    _, jds = _jds(jx, "cdgcn")
    store = hs.TemporalCSRStore.from_snapshots(ds.snapshots, ds.values, N,
                                               block_size=WIN)
    jstore = jx.jhs.TemporalCSRStore.from_snapshots(
        jds.snapshots, jds.values, N, block_size=WIN)
    spec, jspec = hs.SamplingSpec(**TRUNC), jx.jhs.SamplingSpec(**TRUNC)
    stream = hs.SampledSliceStream(store=store, frames=ds.frames,
                                   labels=ds.labels, spec=spec,
                                   resolved=spec.resolve(N, WIN, 1),
                                   win=WIN, device="cpu")
    try:
        got = [rnd for epoch in range(EPOCHS)
               for rnd in stream.rounds(epoch)]
        workers = list(stream._pool._processes.values())
    finally:
        stream.close()
    assert len(got) == EPOCHS * T // WIN and len(workers) == spec.workers
    assert not any(w.is_alive() for w in workers)
    with ThreadPoolExecutor(max_workers=spec.workers) as pool:
        want = [jx.jhs.sample_round(jstore, np.asarray(jds.frames),
                                    np.asarray(jds.labels), jspec,
                                    jspec.resolve(N, WIN, 1), WIN, r, epoch,
                                    pool)
                for epoch in range(EPOCHS) for r in range(T // WIN)]
    for g, w in zip(got, want, strict=True):
        for f in ("node_ids", "frames", "labels", "edges", "mask",
                  "values"):
            _assert_arrays_equal(getattr(g, f), getattr(w, f))
        for f in ("r", "t0", "sampled_edges", "dropped_nodes",
                  "dropped_edges"):
            assert getattr(g, f) == getattr(w, f), f


def test_spec_resolution_and_validation_are_the_reference(jx):
    for kw in ({"batch_nodes": 16, "fanouts": (4, 4)},
               {"batch_nodes": 4096, "fanouts": (10, 10)},
               {"batch_nodes": 16, "fanouts": (4, 4), "table_pad": 30,
                "max_edges": 200},
               {"batch_nodes": 10_000, "fanouts": (2,)}):
        for n, win, p in ((1000, 8, 8), (48, 8, 8), (755_200, 8, 1),
                          (50, 8, 4)):
            got = hs.SamplingSpec(**kw).resolve(n, win, p)
            want = jx.jhs.SamplingSpec(**kw).resolve(n, win, p)
            assert vars(got) == vars(want), (kw, n, win, p)
    for kw in ({"batch_nodes": 0}, {"batch_nodes": 4, "fanouts": ()},
               {"batch_nodes": 4, "workers": 0},
               {"batch_nodes": 4, "table_pad": 0},
               {"batch_nodes": 4, "max_edges": 0}):
        with pytest.raises(ValueError):
            hs.SamplingSpec(**kw).validate()
        with pytest.raises(ValueError):
            jx.jhs.SamplingSpec(**kw).validate()


def test_budget_numbers_are_the_reference(jx):
    kw = dict(num_steps=T, win=WIN, num_shards=4, max_edges=256,
              num_nodes=N, feat_dim=2)
    for mode in ("eager", "streamed", "streamed_mesh"):
        assert hs.full_graph_round_bytes(mode, **kw) == \
            jx.jhs.full_graph_round_bytes(mode, **kw)
    full = hs.full_graph_round_bytes("streamed_mesh", **kw)
    assert full == (WIN // 4) * (256 * 16 + N * 2 * 4 + N * 4)
    resolved = hs.SamplingSpec(12, (3, 3)).resolve(N, WIN, 4)
    jres = jx.jhs.SamplingSpec(12, (3, 3)).resolve(N, WIN, 4)
    assert hs.sampled_round_bytes(resolved, win=WIN, num_shards=4,
                                  feat_dim=2) == \
        jx.jhs.sampled_round_bytes(jres, win=WIN, num_shards=4, feat_dim=2)
    assert hs.check_budget("streamed_mesh", None, **kw) is None
    assert hs.check_budget("streamed_mesh", full, **kw) == \
        {"required": full, "budget": full}
    with pytest.raises(hs.DeviceBudgetError) as got:
        hs.check_budget("streamed_mesh", full - 1, **kw)
    with pytest.raises(jx.jhs.DeviceBudgetError) as want:
        jx.jhs.check_budget("streamed_mesh", full - 1, **kw)
    assert str(got.value) == str(want.value)
    assert "sampled" in str(got.value)
    with pytest.raises(ValueError, match="resolved"):
        hs.check_budget("sampled", 1, **kw)
    with pytest.raises(ValueError, match="no budget model"):
        hs.full_graph_round_bytes("sampled", **kw)


# ---------------------------------------------------------------- carry -----

@pytest.mark.parametrize("model", MODELS)
def test_carry_gather_scatter_roundtrip(model):
    """scatter(gather(...)) is the identity, touched rows update (from
    tensors as from arrays), rows outside the table keep their state,
    and reset re-reads EvolveGCN's w0 from the parameters."""
    cfg, _ = _ds(model)
    params = tm.init_params(torch.Generator().manual_seed(0), cfg)
    cs = hs.HostCarryStore(cfg, params)
    ids = np.array([1, 5, 7, 40], dtype=np.int64)
    pad = 8
    flat = hs.carry.leaves
    g0 = cs.gather(ids, pad)
    cs.scatter(ids, g0)
    g1 = cs.gather(ids, pad)
    for a, b in zip(sum(map(flat, g0), []), sum(map(flat, g1), [])):
        assert np.array_equal(a, b)
    bumped = [hs.carry.rebuild(c, [torch.from_numpy(x + 1.0)
                                   for x in flat(c)])[0] for c in g0]
    cs.scatter(ids, bumped)
    g2 = cs.gather(ids, pad)
    for a, b in zip(sum(map(flat, bumped), []), sum(map(flat, g2), [])):
        a = a.numpy()
        if cs.axis is None:
            assert np.array_equal(a, b)
        else:
            sl = (slice(0, 4) if cs.axis == 0 else (slice(None), slice(0, 4)))
            assert np.array_equal(a[sl], b[sl])
    if cs.axis is not None:
        other = cs.gather(np.array([2], dtype=np.int64), pad)
        for leaf in sum(map(flat, other), []):
            assert np.all(leaf == 0.0)
        assert cs.nbytes == sum(a.nbytes for layer in cs.arrays()
                                for a in layer)
    else:
        with torch.no_grad():
            params["layers"][0]["evolve"]["w0"].add_(1.0)
        cs.reset(params)
        w0 = params["layers"][0]["evolve"]["w0"].detach().numpy()
        assert np.array_equal(cs.arrays()[0][0], w0)


# ---------------------------------------------------- train_sampled vs JAX --

@pytest.mark.parametrize("model", MODELS)
def test_full_fanout_matches_jax_and_the_full_graph(pool, jx, jruns, model):
    """Every vertex a seed, full fanout: the 4 ranks' losses within 1e-5
    relative of JAX's ``train_sampled`` on 4 host devices, the parameters
    within 1e-6 (``tests/test_hoststore.py``), no lane dropped; and the
    sampled run equals the port's own ``streamed_mesh`` run (1e-5)."""
    got = _same_on_every_rank(pool, model)
    want = jruns[model]
    assert len(got["losses"]) == len(want.losses) == EPOCHS * NB
    np.testing.assert_allclose(got["losses"], want.losses, rtol=1e-5)
    jp = _named(jx, want.params)
    assert got["params"].keys() == jp.keys()
    for k, v in got["params"].items():
        np.testing.assert_allclose(v, jp[k], atol=1e-6, err_msg=k)
    assert got["dropped"] == (0, 0) and got["rounds"] == EPOCHS * NB
    full = pool[0]["train"][f"{model}-streamed_mesh"]
    np.testing.assert_allclose(got["losses"], full["losses"], rtol=1e-5)
    for k, v in got["params"].items():
        np.testing.assert_allclose(v, full["params"][k], atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("model", ["tmgcn", "cdgcn"])
def test_truncated_fanout_matches_jax(pool, jx, jruns, model):
    """GraphSAGE-style rounds (24 seeds, fanout 4-4): the same sampled
    rounds as JAX, so the same loss stream (1e-5) and parameters (1e-6);
    the prefetch thread on and off identical."""
    got = _same_on_every_rank(pool, f"{model}-trunc")
    want = jruns[f"{model}-trunc"]
    np.testing.assert_allclose(got["losses"], want.losses, rtol=1e-5)
    jp = _named(jx, want.params)
    for k, v in got["params"].items():
        np.testing.assert_allclose(v, jp[k], atol=1e-6, err_msg=k)
    assert got["sampled_edges"] == want.report.sampled_edges
    if model == "cdgcn":
        sync = pool[0]["train"]["cdgcn-trunc-sync"]
        assert sync["losses"] == got["losses"]


@pytest.mark.parametrize("key", ["tmgcn", "cdgcn", "evolvegcn",
                                 "tmgcn-trunc", "cdgcn-trunc"])
def test_carry_stores_are_identical_across_ranks_after_every_round(pool,
                                                                   key):
    """Each rank's store takes every rank's post-round rows (one
    all-gather, the same scatter): byte-identical after every round."""
    first = pool[0]["train"][key]["stores"]
    assert len(first) == EPOCHS * NB
    for r in pool[1:]:
        for a_round, b_round in zip(r["train"][key]["stores"], first,
                                    strict=True):
            for a, b in zip(a_round, b_round, strict=True):
                _assert_arrays_equal(a, b)
    # the rounds move the state: not every round's store is the first's
    assert any(not np.array_equal(a, b) for a, b in
               zip(first[0], first[-1], strict=True))


def test_staged_bytes_are_the_ranks_slices(pool):
    """A rank ships its (win/P)-step slice of each round and its
    table_pad/P lanes of the carries: the four ranks alike, and a
    quarter of one device's whole round."""
    got = [r["train"]["cdgcn-trunc"]["staged_bytes"] for r in pool]
    assert len(set(got)) == 1
    resolved = hs.SamplingSpec(**TRUNC).resolve(N, WIN, P)
    tp, ep = resolved.table_pad, resolved.edge_pad
    per_round = (WIN // P) * (tp * 2 * 4 + tp * 4 + ep * (8 + 4 + 4)) \
        + 2 * 2 * (tp // P) * 6 * 4       # 2 layers x (h, c) lanes
    assert got[0] == EPOCHS * NB * per_round


# --------------------------------------------------------- Engine, budget ---

def test_engine_sampled_mode_matches_the_jax_engine(pool, jx):
    """``Engine(mode="sampled", shards=4)`` on N = 50: not padded (the
    table pads), the loss stream within 1e-5 of the JAX Engine's, the
    ranks' parameters bit-identical."""
    want = jx.JEngine(jx.JRunConfig(
        model=jx.jm.DynGNNConfig(model="cdgcn", num_nodes=ENGINE_N,
                                 num_steps=T, checkpoint_blocks=NB),
        data=jx.JTrace(num_nodes=ENGINE_N, num_steps=T, density=2.0,
                       seed=1),
        plan=jx.JPlan(mode="sampled", shards=P, num_epochs=EPOCHS,
                      sampling=jx.JSpec(**ENGINE_SPEC)),
        log_fn=_silent)).fit()
    got = pool[0]["engine"]
    assert got["num_nodes"] == ENGINE_N
    np.testing.assert_allclose(got["losses"], want.losses, rtol=1e-5)
    assert got["rounds"] == want.sample_report.rounds == EPOCHS * NB
    assert got["table_fill_max"] == want.sample_report.table_fill_max
    assert got["budget_report"] is None and got["step"] == EPOCHS * NB
    for r in pool[1:]:
        assert r["engine"]["losses"] == got["losses"]
        for k, v in r["engine"]["params"].items():
            np.testing.assert_array_equal(v, got["params"][k], err_msg=k)


def test_budget_refuses_full_graph_schedules_and_sampled_fits(pool):
    """A budget of one sampled round: eager, streamed and streamed_mesh
    raise ``DeviceBudgetError`` (needing more than it), the sampled
    schedule trains within it and stages fewer bytes than a full
    round."""
    for r in pool:
        b = r["budget"]
        for mode, refused in b["refused"].items():
            assert refused is not None, mode
            assert refused[0] == mode and refused[1] > b["budget"]
        assert b["budget_report"]["budget"] == b["budget"]
        assert b["budget_report"]["required"] <= b["budget"]
        assert len(b["losses"]) == NB and b["rounds"] == NB
        assert 0 < b["staged_bytes"]


@pytest.mark.parametrize("label,ranks", [("P1", 1), ("P4", 4)])
def test_launch_and_csr_build_counts_a_round(pool, label, ranks):
    """A full-fanout TM-GCN round over P ranks is the distributed
    stream's round on the table: per rank 3 win/P aggregates (2 forward,
    1 backward a step), 2 M-products, 2 transposed bands, 2 win/P CSR
    builds."""
    bsl = WIN // ranks
    for r in pool:
        got = r["launches"][label]
        assert got["per_round"] == {"spmm": 3 * bsl, "ttm": 2, "ttm_t": 2}
        assert got["csr_builds"] == 2 * bsl


# ------------------------------------------------------- plan and CLI -------

def test_plan_validation_sampled():
    with pytest.raises(ValueError, match="needs plan.sampling"):
        ExecutionPlan(mode="sampled").validate()
    with pytest.raises(ValueError, match="requires mode='sampled'"):
        ExecutionPlan(mode="eager",
                      sampling=SamplingSpec(batch_nodes=4)).validate()
    with pytest.raises(ValueError, match="device_budget_bytes"):
        ExecutionPlan(device_budget_bytes=0).validate()
    with pytest.raises(ValueError, match="batch_nodes"):
        ExecutionPlan(mode="sampled",
                      sampling=SamplingSpec(batch_nodes=0)).validate()
    plan = ExecutionPlan(mode="sampled", shards=4,
                         sampling=SamplingSpec(batch_nodes=4))
    plan.validate()
    assert plan.padded_num_nodes(50) == 50
    assert plan.resolved_blocks(16, 2) == 2
    with pytest.raises(ValueError, match="--sampled --mesh 4"):
        plan.build_mesh()
    ExecutionPlan(mode="streamed", device_budget_bytes=1 << 20).validate()


@pytest.mark.parametrize("flags,match", [
    (["--sampled", "--stream"], "drop --stream"),
    (["--fanout", "3,3"], "require --sampled"),
    (["--sample-batch", "4"], "require --sampled"),
    (["--sampled", "--fanout", "3,x"], "bad --fanout"),
    (["--sampled", "--mesh", "2"], "torchrun --nproc-per-node 2"),
    (["--stream", "--device-budget", "1000"], "refused: schedule 'streamed'"),
    (["--steps", "2", "--device-budget", "1000"],
     "refused: schedule 'eager'")])
def test_launcher_rules_for_the_sampled_schedule(flags, match):
    from repro_torch.launch import train as launch_train
    with pytest.raises(SystemExit, match=match):
        launch_train.main(["--arch", "tmgcn", "--device", "cpu", *flags])


def test_torchrun_launcher_samples_on_two_ranks():
    """``torchrun --standalone --nproc-per-node 2 -m
    repro_torch.launch.train --sampled --mesh 2 --device cpu``: both ranks
    train, rank 0 alone prints the reference's summary line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "paper_dyngnn", "--sampled", "--mesh", "2",
         "--fanout", "5,5", "--device-budget", str(1 << 30), "--device",
         "cpu"], capture_output=True, text=True, timeout=120, env=env,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    done = [ln for ln in out.stdout.splitlines()
            if ln.startswith("sampled ") and " rounds on " in ln]
    assert len(done) == 1, out.stdout
    assert done[0].startswith("sampled 2 rounds on 2 shards, final loss ")
    assert "(dropped 0 edges / 0 nodes)" in done[0]
    assert done[0].endswith(f"/{1 << 30} B")
