"""Snapshot partitioning (paper §4.2) in the port, on 4 gloo ranks, held to
the JAX package's ``shard_map`` over 4 host devices.

One pool of 4 rank processes per module (``pool``) runs every case on the
CPU and writes each rank's results to ``tmp_path``; the tests below read
them and compare with the JAX package, computed here in the parent, at
the reference's own tolerances.  The ranks are started with the spawn
method and import this module for its rank program, so the module imports
no JAX at its top: the JAX side is the ``jx`` fixture's.  Sizes are
``tests/test_partitioning.py``'s (N = 32, T = 16, window 3, nb 2), the
Engine's ``tests/test_torch_train.py``'s with N = 46, which the plan pads
to 48 over 4 ranks.

* ``snapshot_partition_forward`` against JAX: atol 1e-5; the loss and its
  gradients (each rank's share differentiated, one all-reduce per leaf)
  against ``jax.value_and_grad``: 1e-6 and 1e-5; ``fuse_final`` against
  plain: rtol 1e-6; bf16 payloads: relative error under 5e-2
  (``tests/test_perf_variants.py``); ``a2a_chunks = 2`` bit-identical to 1;
* ``vertex_partition_forward`` against JAX: atol 1e-5;
* ``t_to_n`` / ``n_to_t`` against ``jax.lax.all_to_all(tiled=True)``;
* the bytes handed to the all-to-alls by a forward equal the law
  (``comm_volume.snapshot_partition_volume``; cdgcn's T->N payload is
  ``d_in + d_gcn`` wide) at P = 2 and 4, and a training step's count
  (forward, the checkpoint recompute up to its early stop, backward);
* a 6-step ``Engine`` loss stream on 4 ranks against the JAX Engine with
  ``ExecutionPlan(mode="eager", shards=4)``: rtol 1e-5, the parameters
  bit-identical across the ranks; the Engine on a one-rank group against
  the single-device step; launch counts a step;
* the copied numpy (``partition_edges_by_dst``, ``comm_volume``)
  byte-identical to the reference; the plan's rules and refusals; and the
  ``torchrun`` launcher on 2 ranks.
"""

import datetime
import os
import pickle
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import convert, obs
from repro_torch.core import dtdg, partition
from repro_torch.core import models as tm
from repro_torch.data import dyngnn as data
from repro_torch.dist import comm_volume as cv
from repro_torch.dist.sharding import ShardLayout, n_to_t, t_to_n
from repro_torch.graph import generate
from repro_torch.kernels.mproduct import ops as mp_ops
from repro_torch.kernels.segment_spmm import ops as spmm_ops
from repro_torch.optim import adamw
from repro_torch.run import Engine, ExecutionPlan, RunConfig, SyntheticTrace
from repro_torch.train import trainer

ROOT = Path(__file__).resolve().parents[1]
P = 4
T, N, W, NB = 16, 32, 3, 2
ENGINE_N, ENGINE_STEPS = 46, 6
MODELS = ["cdgcn", "evolvegcn", "tmgcn"]
SMOOTH = {"tmgcn": "mproduct", "evolvegcn": "edgelife", "cdgcn": "none"}
POOL_DEADLINE_S = 150
LAYOUT_F = 3


# ------------------------------------------------------- the rank program ---

def _silent(_msg):
    return None


def _setup(model, nb=NB):
    """``tests/test_partitioning.py::_setup`` in the port (its numpy copies)."""
    snaps = generate.evolving_dynamic_graph(N, T, density=2.0, churn=0.1,
                                            seed=0)
    frames = np.stack([generate.degree_features(s, N) for s in snaps])
    batch = dtdg.build_batch(snaps, frames, N, device="cpu")
    cfg = tm.DynGNNConfig(model=model, num_nodes=N, num_steps=T, window=W,
                          checkpoint_blocks=nb)
    labels = torch.from_numpy(
        np.random.default_rng(0).integers(0, 2, size=(T, N)))
    return cfg, batch, labels


def _local(layout, batch, labels):
    fr, ed, ew = (layout.local(a) for a in
                  partition.blockify_batch(batch, layout.nb))
    return fr, ed, ew, layout.local(labels.reshape(layout.nb, -1, N))


def _counters():
    return dict(obs.metrics_snapshot()["counters"])


def _a2a_delta(before):
    now = _counters()
    return {k: now.get(k, 0) - before.get(k, 0) for k in
            ("partition.a2a_calls", "partition.a2a_bytes",
             "partition.a2a_remote_bytes")}


def _named_grads(params, grads):
    names = [k for k, _ in params.named_parameters()]
    return {k: g.numpy().copy() for k, g in zip(names, grads, strict=True)}


def _reduced_grads(share, params, group):
    grads = torch.autograd.grad(share, list(params.parameters()))
    for g in grads:
        dist.all_reduce(g, group=group)
    loss = share.detach().clone()
    dist.all_reduce(loss, group=group)
    return float(loss), _named_grads(params, grads)


def _case_forward(rank, group, jparams):
    out = {}
    for model in MODELS:
        cfg, batch, labels = _setup(model)
        params = convert.params_from_jax(jparams[model])
        layout = ShardLayout.of(group, NB, T // NB, N)
        fr, ed, ew, lab = _local(layout, batch, labels)
        res = {}
        with torch.no_grad():
            before = _counters()
            res["z"] = partition.snapshot_partition_forward(cfg, group)(
                params, fr, ed, ew).numpy()
            res["bytes"] = _a2a_delta(before)
            res["z_chunked"] = partition.snapshot_partition_forward(
                cfg, group, a2a_chunks=2)(params, fr, ed, ew).numpy()
        before = _counters()
        share = partition.snapshot_partition_loss(cfg, group)(
            params, fr, ed, ew, lab)
        res["loss"], res["grads"] = _reduced_grads(share, params, group)
        res["step_bytes"] = _a2a_delta(before)
        share = partition.snapshot_partition_loss(cfg, group, a2a_chunks=2)(
            params, fr, ed, ew, lab)
        res["loss_chunked"], res["grads_chunked"] = _reduced_grads(
            share, params, group)
        out[model] = res
    return out


def _case_variants(rank, group, jparams):
    out = {}
    for model, kw in (("tmgcn", "fused"), ("cdgcn", "fused"),
                      ("tmgcn", "bf16")):
        cfg, batch, labels = _setup(model)
        params = convert.params_from_jax(jparams[model])
        layout = ShardLayout.of(group, NB, T // NB, N)
        fr, ed, ew, lab = _local(layout, batch, labels)
        if kw == "fused":
            fn = partition.snapshot_partition_loss(cfg, group,
                                                   fuse_final=True)
            lab = layout.local_vertices(labels.reshape(NB, T // NB, N))
        else:
            fn = partition.snapshot_partition_loss(
                cfg, group, comm_dtype=torch.bfloat16)
        with torch.no_grad():
            share = fn(params, fr, ed, ew, lab)
        dist.all_reduce(share, group=group)
        out[f"{kw}-{model}"] = float(share)
    return out


def _case_vertex(rank, group, jparams):
    """``tests/test_partitioning.py::test_vertex_partition_matches_
    reference``'s edge and weight layout, this rank's share of it."""
    out = {}
    n_per = N // P
    for model in MODELS:
        cfg, batch, _ = _setup(model, nb=1)
        params = convert.params_from_jax(jparams[model])
        edges_p, w_p = partition.partition_edges_by_dst(
            batch.edges, batch.edge_mask, N, P,
            max_local_edges=batch.edges.shape[1])
        ew_p = _vertex_weights(batch, w_p)
        with torch.no_grad():
            z = partition.vertex_partition_forward(cfg, group)(
                params, batch.frames[:, rank * n_per:(rank + 1) * n_per],
                torch.from_numpy(edges_p[:, rank]),
                torch.from_numpy(ew_p[:, rank]))
        out[model] = z.numpy()
    return out


def _vertex_weights(batch, w_p):
    """Each destination shard's Laplacian weights, in the order
    ``partition_edges_by_dst`` keeps its edges."""
    w_full = np.asarray(batch.edge_weights)
    ew_p = np.zeros_like(w_p)
    for t in range(T):
        e = np.asarray(batch.edges[t])
        m = np.asarray(batch.edge_mask[t]) > 0
        own = e[m][:, 1] // (N // P)
        ew_t = w_full[t][m]
        for p in range(P):
            sel = ew_t[own == p]
            ew_p[t, p, :sel.shape[0]] = sel
    return ew_p


def _case_layout(rank, group, jparams):
    bsize = 2 * P
    x = torch.arange(bsize * N * LAYOUT_F, dtype=torch.float32).reshape(
        bsize, N, LAYOUT_F)
    mine = x[rank * 2:(rank + 1) * 2]
    y = t_to_n(mine, group)
    back = n_to_t(y, group)
    return {"t_to_n": y.numpy(), "round_trip": bool(torch.equal(back, mine))}


def _case_bytes_p2(rank, pair, jparams):
    """A no-grad forward on the group of ranks 0 and 1."""
    if rank >= 2:
        return None
    out = {}
    for model in MODELS:
        cfg, batch, _ = _setup(model)
        params = convert.params_from_jax(jparams[model])
        layout = ShardLayout.of(pair, NB, T // NB, N)
        fr, ed, ew = (layout.local(a) for a in
                      partition.blockify_batch(batch, NB))
        before = _counters()
        with torch.no_grad():
            partition.snapshot_partition_forward(cfg, pair)(params, fr, ed,
                                                            ew)
        out[model] = _a2a_delta(before)
    return out


def _engine_cfg(model, n=ENGINE_N):
    return tm.DynGNNConfig(model=model, num_nodes=n, num_steps=T, window=W,
                           checkpoint_blocks=NB)


def _engine_data(model):
    return SyntheticTrace(num_nodes=ENGINE_N, num_steps=T, density=2.0,
                          churn=0.1, smoothing_mode=SMOOTH[model], window=W)


def _case_engine(rank, group, jparams):
    out = {}
    for model in MODELS:
        eng = Engine(RunConfig(model=_engine_cfg(model),
                               data=_engine_data(model),
                               plan=ExecutionPlan(mode="eager", shards=P,
                                                  num_steps=ENGINE_STEPS),
                               log_fn=_silent),
                     params=convert.params_from_jax(jparams[model]),
                     device="cpu")
        res = eng.fit()
        rr = eng.resolve()
        out[model] = {"losses": res.losses,
                      "params": convert.params_to_numpy(res.state.params),
                      "num_nodes": rr.cfg.num_nodes,
                      "padded_from": rr.padded_from,
                      "a2a_calls": res.metrics["counters"].get(
                          "partition.a2a_calls", 0)}
    return out


def _case_engine_one_rank(rank, single, jparams):
    """Rank r trains model r on its own one-rank group and on one device."""
    if rank >= len(MODELS):
        return None
    model = MODELS[rank]
    out = {}
    for name, plan in (("group", ExecutionPlan(mesh=single, num_steps=4)),
                       ("single", ExecutionPlan(num_steps=4))):
        res = Engine(RunConfig(model=_engine_cfg(model, n=48),
                               data=_engine_data(model), plan=plan,
                               log_fn=_silent),
                     params=convert.params_from_jax(jparams[model]),
                     device="cpu").fit()
        out[name] = (res.losses, convert.params_to_numpy(res.state.params),
                     res.metrics["counters"].get("partition.a2a_calls", 0))
    return {"model": model, **out}


def _case_launches(rank, groups, jparams):
    """Kernel launches (their plain versions, reached through the same
    wrappers) and CSR builds of three partitioned TM-GCN steps, on a
    one-rank group and on the 4 ranks."""
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
        cfg = _engine_cfg("tmgcn", n=48)
        ds = _engine_data("tmgcn").build(num_nodes=48)
        for label, group in groups.items():
            pipe = data.DTDGPipeline(ds, nb=NB, device="cpu")
            layout = ShardLayout.of(group, NB, T // NB, 48)
            args = pipe.rank_arrays(layout)
            spmm_ops.csr_builds = 0
            csrs = pipe.rank_batch(layout).csr_pairs()
            builds = spmm_ops.csr_builds
            params = convert.params_from_jax(jparams["tmgcn"])
            opt = adamw.init_state(params)
            step = trainer.make_dyngnn_train_step(
                cfg, group, adamw.AdamWConfig(total_steps=3))
            for key in calls:
                calls[key] = 0
            for _ in range(3):
                params, opt, _ = step(params, opt, *args, csrs=csrs)
            out[label] = {"per_step": {k: v / 3 for k, v in calls.items()},
                          "csr_builds": builds,
                          "rank_steps": int(args[0].shape[0] * args[0].shape[1])}
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
        pair = dist.new_group([0, 1])
        singles = [dist.new_group([r]) for r in range(P)]
        res = {"forward": _case_forward(rank, world, jparams),
               "variants": _case_variants(rank, world, jparams),
               "vertex": _case_vertex(rank, world, jparams),
               "layout": _case_layout(rank, world, jparams),
               "bytes_p2": _case_bytes_p2(rank, pair, jparams),
               "engine": _case_engine(rank, world, jparams),
               "engine_one_rank": _case_engine_one_rank(
                   rank, singles[rank], jparams),
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
    import jax.numpy as jnp

    from repro.core import dtdg as jdtdg
    from repro.core import models as jm
    from repro.core import partition as jpart
    from repro.dist import comm_volume as jcv
    from repro.graph import generate as jgen
    from repro.launch.mesh import make_host_mesh
    from repro.run import Engine as JEngine
    from repro.run import ExecutionPlan as JPlan
    from repro.run import RunConfig as JRunConfig
    from repro.run import SyntheticTrace as JTrace
    return types.SimpleNamespace(**locals())


@pytest.fixture(scope="module")
def jparams(jx):
    """Each model's JAX parameters (``PRNGKey(0)``, the JAX Engine's
    seed-0 init) as numpy trees."""
    return {m: jx.jax.tree.map(np.asarray, jx.jm.init_params(
        jx.jax.random.PRNGKey(0), _jcfg(jx, m))) for m in MODELS}


@pytest.fixture(scope="module")
def pool(tmp_path_factory, jparams):
    """Every case on 4 gloo ranks -> [rank 0's results, ..., rank 3's]."""
    d = tmp_path_factory.mktemp("partition")
    run_ranks(_rank_main, P, (str(d / "store"), str(d), jparams),
              POOL_DEADLINE_S)
    out = []
    for r in range(P):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _jcfg(jx, model, nb=NB, n=N):
    return jx.jm.DynGNNConfig(model=model, num_nodes=n, num_steps=T,
                              window=W, checkpoint_blocks=nb)


def _jsetup(jx, model, nb=NB):
    snaps = jx.jgen.evolving_dynamic_graph(N, T, density=2.0, churn=0.1,
                                           seed=0)
    frames = np.stack([jx.jgen.degree_features(s, N) for s in snaps])
    batch = jx.jdtdg.build_batch(snaps, frames, N)
    labels = jx.jnp.asarray(
        np.random.default_rng(0).integers(0, 2, size=(T, N)))
    return _jcfg(jx, model, nb), batch, labels


def _named(jx, tree) -> dict:
    return {jx.jax.tree_util.keystr(k, simple=True, separator="."):
            np.asarray(v)
            for k, v in jx.jax.tree_util.tree_flatten_with_path(tree)[0]}


def _gather_time(parts):
    """Each rank's (nb, bsl, ...) share -> the blocked (nb, bsize, ...)."""
    return np.concatenate(parts, axis=1)


# ------------------------------------------------------- snapshot parity ----

@pytest.mark.parametrize("model", MODELS)
def test_snapshot_partition_forward_matches_jax(pool, jx, jparams, model):
    cfg, batch, _ = _jsetup(jx, model)
    fwd = jx.jpart.snapshot_partition_forward(
        cfg, jx.make_host_mesh(data=P, model=1))
    fr, ed, ew = jx.jpart.blockify_batch(batch, NB)
    want = np.asarray(jx.jax.jit(fwd)(jparams[model], fr, ed, ew))
    got = _gather_time([r["forward"][model]["z"] for r in pool])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("model", MODELS)
def test_snapshot_partition_gradients_match_jax(pool, jx, jparams, model):
    """Each rank differentiates its share; one all-reduce per leaf gives
    ``jax.value_and_grad`` of the sharded loss, the same on every rank."""
    cfg, batch, labels = _jsetup(jx, model)
    lossfn = jx.jpart.snapshot_partition_loss(
        cfg, jx.make_host_mesh(data=P, model=1))
    fr, ed, ew = jx.jpart.blockify_batch(batch, NB)
    lab_b = labels.reshape(NB, T // NB, N)
    loss, grads = jx.jax.jit(jx.jax.value_and_grad(
        lambda p: lossfn(p, fr, ed, ew, lab_b)))(jparams[model])
    want = _named(jx, grads)
    for r in pool:
        got = r["forward"][model]
        assert abs(got["loss"] - float(loss)) <= 1e-6
        assert got["grads"].keys() == want.keys()
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g, want[k], atol=1e-5, err_msg=k)
            np.testing.assert_array_equal(g, pool[0]["forward"][model][
                "grads"][k])


@pytest.mark.parametrize("variant", ["fused-tmgcn", "fused-cdgcn",
                                     "bf16-tmgcn"])
def test_fused_final_and_bf16_payloads_match_plain(pool, variant):
    """``tests/test_perf_variants.py``'s bounds: dropping the last N -> T
    all-to-all keeps the loss (rtol 1e-6); bf16 payloads stay within 5e-2
    relative."""
    plain = pool[0]["forward"][variant.split("-")[1]]["loss"]
    for r in pool:
        got = r["variants"][variant]
        if variant.startswith("fused"):
            np.testing.assert_allclose(got, plain, rtol=1e-6)
        else:
            assert abs(got - plain) / abs(plain) < 5e-2
            assert got != plain             # the payloads were cast


@pytest.mark.parametrize("model", ["cdgcn", "tmgcn"])
def test_a2a_chunks_are_bit_identical(pool, model):
    for r in pool:
        got = r["forward"][model]
        np.testing.assert_array_equal(got["z_chunked"], got["z"])
        assert got["loss_chunked"] == got["loss"]
        for k, g in got["grads"].items():
            np.testing.assert_array_equal(got["grads_chunked"][k], g)


@pytest.mark.parametrize("model", MODELS)
def test_vertex_partition_forward_matches_jax(pool, jx, jparams, model):
    cfg, batch, _ = _jsetup(jx, model, nb=1)
    fwd = jx.jpart.vertex_partition_forward(
        cfg, jx.make_host_mesh(data=P, model=1))
    edges_p, w_p = jx.jpart.partition_edges_by_dst(
        batch.edges, batch.edge_mask, N, P,
        max_local_edges=batch.edges.shape[1])
    ew_p = _vertex_weights(batch, w_p)
    e_stack = jx.jnp.asarray(edges_p).reshape(T, P * edges_p.shape[2], 2)
    w_stack = jx.jnp.asarray(ew_p).reshape(T, P * ew_p.shape[2])
    want = np.asarray(jx.jax.jit(fwd)(jparams[model], batch.frames, e_stack,
                                      w_stack))
    got = np.concatenate([r["vertex"][model] for r in pool], axis=1)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_t_to_n_and_n_to_t_lay_out_as_jax_tiled_all_to_all(pool, jx):
    """Rank r's T->N output is JAX's local block on device r of
    ``all_to_all(split_axis=1, concat_axis=0, tiled=True)`` over the
    time-sharded input; N->T gives each rank its input back."""
    from functools import partial

    from jax.sharding import PartitionSpec as JP

    from repro.compat import shard_map
    mesh = jx.make_host_mesh(data=P, model=1)
    bsize = 2 * P
    x = np.arange(bsize * N * LAYOUT_F, dtype=np.float32).reshape(
        bsize, N, LAYOUT_F)
    fn = shard_map(partial(jx.jax.lax.all_to_all, axis_name="data",
                           split_axis=1, concat_axis=0, tiled=True),
                   mesh=mesh, in_specs=JP("data"), out_specs=JP("data"),
                   check_vma=False)
    # out_specs P("data") stacks each device's (bsize, N/P, F) block
    want = np.asarray(jx.jax.jit(fn)(x)).reshape(P, bsize, N // P, LAYOUT_F)
    for r, res in enumerate(pool):
        np.testing.assert_array_equal(res["layout"]["t_to_n"], want[r])
        assert res["layout"]["round_trip"]


def _law_bytes(cfg, p):
    """Forward bytes over all ranks: 2 all-to-alls per layer of the (T, N,
    f) payloads, (P - 1) / P of each leaving its rank, f32."""
    dims = partition.a2a_payload_dims(cfg)
    return 4 * sum(f1 + f2 for f1, f2 in dims) * T * N * (p - 1) // p


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("model", MODELS)
def test_forward_bytes_equal_the_law(pool, p, model):
    """The counter of a no-grad forward, summed over the ranks, equals
    ``snapshot_partition_volume`` (TM-GCN: both redistributions 6 wide);
    cdgcn's T->N payload is d_in + d_gcn wide (8 and 12)."""
    ranks = pool if p == 4 else pool[:2]
    key = "forward" if p == 4 else "bytes_p2"
    got = [(r[key][model]["bytes"] if p == 4 else r[key][model])
           for r in ranks]
    remote = sum(g["partition.a2a_remote_bytes"] for g in got)
    cfg = tm.DynGNNConfig(model=model, num_nodes=N, num_steps=T, window=W,
                          checkpoint_blocks=NB)
    assert remote == _law_bytes(cfg, p)
    if model == "tmgcn":
        assert remote == 4 * cv.snapshot_partition_volume(
            T, N, 6, cfg.num_layers, p, model)
    if model == "cdgcn":
        assert partition.a2a_payload_dims(cfg) == [(8, 6), (12, 6)]
    calls = 0 if model == "evolvegcn" else 2 * cfg.num_layers * NB
    for g in got:
        assert g["partition.a2a_calls"] == calls
        assert g["partition.a2a_bytes"] * (p - 1) == \
            g["partition.a2a_remote_bytes"] * p


@pytest.mark.parametrize("model,ratio", [("tmgcn", 2.5),
                                         ("cdgcn", 90 / 32)])
def test_a_training_step_sends_a_fixed_multiple_of_the_law(pool, model,
                                                           ratio):
    """A step's all-to-alls per block: the forward's 2 L, the checkpoint
    recompute's up to the last tensor the backward needs (TM-GCN: the
    last layer's relu, so 2 L - 2; CD-GCN: its LSTM, so 2 L - 1) and the
    backward's 2 L, one for each forward all-to-all.  In bytes: TM-GCN's
    payloads are all 6 wide, (24 + 12 + 24) / 24 = 2.5 times the law;
    CD-GCN's are 8, 6, 12, 6 wide, (32 + 26 + 32) / 32."""
    step = [r["forward"][model]["step_bytes"] for r in pool]
    fwd = [r["forward"][model]["bytes"] for r in pool]
    assert sum(s["partition.a2a_remote_bytes"] for s in step) == \
        ratio * sum(f["partition.a2a_remote_bytes"] for f in fwd)
    layers = 2
    recompute = 2 * layers - (2 if model == "tmgcn" else 1)
    for s in step:
        assert s["partition.a2a_calls"] == NB * (4 * layers + recompute)


# ------------------------------------------------------------- Engine -------

@pytest.mark.parametrize("model", MODELS)
def test_engine_on_four_ranks_matches_the_jax_engine(pool, jx, model):
    """N = 46 pads to 48 on both sides (isolated nodes, counted in the
    loss); the loss streams agree at rtol 1e-5 and the ranks end with
    bit-identical parameters."""
    want = jx.JEngine(jx.JRunConfig(
        model=_jcfg(jx, model, n=ENGINE_N),
        data=jx.JTrace(num_nodes=ENGINE_N, num_steps=T, density=2.0,
                       churn=0.1, smoothing_mode=SMOOTH[model], window=W),
        plan=jx.JPlan(mode="eager", shards=P, num_steps=ENGINE_STEPS),
        log_fn=_silent)).fit()
    got = pool[0]["engine"][model]
    assert got["num_nodes"] == 48 and got["padded_from"] == ENGINE_N
    np.testing.assert_allclose(got["losses"], want.losses, rtol=1e-5)
    assert len(got["losses"]) == ENGINE_STEPS
    for r in pool[1:]:
        assert r["engine"][model]["losses"] == got["losses"]
        for k, v in r["engine"][model]["params"].items():
            np.testing.assert_array_equal(v, got["params"][k], err_msg=k)
    jp = _named(jx, want.state.params)
    for k, v in got["params"].items():
        np.testing.assert_allclose(v, jp[k], atol=1e-4, err_msg=k)
    assert got["a2a_calls"] == (0 if model == "evolvegcn" else
                                ENGINE_STEPS * NB * (
                                    8 + (2 if model == "tmgcn" else 3)))


@pytest.mark.parametrize("model", MODELS)
def test_engine_on_a_one_rank_group_matches_the_single_device_step(
        pool, model):
    """An explicit group of size 1 runs the partitioned step (its
    all-to-alls issued, nothing leaving the rank) and matches the
    single-device Engine at rtol 1e-5."""
    res = next(r["engine_one_rank"] for r in pool
               if r["engine_one_rank"] and
               r["engine_one_rank"]["model"] == model)
    (g_loss, g_params, g_calls), (s_loss, s_params, s_calls) = \
        res["group"], res["single"]
    np.testing.assert_allclose(g_loss, s_loss, rtol=1e-5)
    for k, v in g_params.items():
        np.testing.assert_allclose(v, s_params[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert s_calls == 0
    assert g_calls == (0 if model == "evolvegcn" else 4 * NB * (
        8 + (2 if model == "tmgcn" else 3)))


@pytest.mark.parametrize("label,ranks", [("P1", 1), ("P4", 4)])
def test_partitioned_step_launch_counts(pool, label, ranks):
    """Per step and rank, TM-GCN with L layers in nb blocks over a rank's
    T / P steps: the aggregate L T/P forward, L T/P in the recompute and
    T/P backward (layer 1's input needs none); the M-product L nb forward
    and nb in the recompute (each rank runs the temporal stage of every
    block on its vertices), its transpose L nb; the rank's CSR pairs once
    per run (2 T/P).  At P = 1 these are the single-device step's counts,
    which ``chip_smoke.py`` checks on the card (160 / 12 / 8 at T = 32,
    nb 4)."""
    layers, steps = 2, T // ranks
    for r in pool:
        got = r["launches"][label]
        assert got["rank_steps"] == steps
        assert got["per_step"] == {"spmm": (2 * layers + 1) * steps,
                                   "ttm": layers * NB + NB,
                                   "ttm_t": layers * NB}
        assert got["csr_builds"] == 2 * steps


# ------------------------------------------------ copies of the reference ---

def test_partition_edges_by_dst_is_the_reference(jx):
    _, batch, _ = _setup("tmgcn", nb=1)
    _, jbatch, _ = _jsetup(jx, "tmgcn", nb=1)
    for p, cap in ((4, batch.edges.shape[1]), (2, 40)):
        got = partition.partition_edges_by_dst(batch.edges, batch.edge_mask,
                                               N, p, cap)
        want = jx.jpart.partition_edges_by_dst(jbatch.edges,
                                               jbatch.edge_mask, N, p, cap)
        for a, b in zip(got, want, strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


_SNAPS = generate.evolving_dynamic_graph(64, 6, density=3.0, churn=0.2,
                                         seed=2)


@pytest.mark.parametrize("fn,args", [
    ("snapshot_partition_volume", [(64, 1024, 6, 2, p, m) for p in
                                   (1, 2, 4, 64) for m in
                                   ("tmgcn", "evolvegcn")]),
    ("alltoall_round_payload", [(8, 1024, 6, 2, p, 4.0, c, k) for p in
                                (1, 4) for c in ("none", "int8_a2a")
                                for k in (1, 3)]),
    ("allgather_vertex_volume", [(64, 1024, 6, 2, p) for p in (1, 4, 16)]),
    ("index_width", [(32767,), (32768,)]),
    ("streamed_shard_volume", [(64, 4, 16, 1e6, 1e4), (8, 8, 8, 5.0, 1.0)]),
    ("rescale_payload", [(100.0, 50.0, 4, 8), (100.0, 50.0, 8, 4),
                         (3.0, 1.0, 2, 2)]),
    ("bfs_partition", [(np.concatenate(_SNAPS), 64, p) for p in (2, 8)]),
    ("vertex_partition_volume", [(_SNAPS, 64, 6, 2, 4, np.arange(64) % 4)])])
def test_comm_volume_laws_are_the_reference(jx, fn, args):
    for a in args:
        got, want = getattr(cv, fn)(*a), getattr(jx.jcv, fn)(*a)
        assert type(got) is type(want)
        np.testing.assert_array_equal(got, want)
    for kw in ({"wire": "none"}, {"wire": "int8"}):
        assert cv.delta_wire_bytes(3, 5, 40, num_nodes=70_000,
                                   max_edges=1 << 16, **kw) == \
            jx.jcv.delta_wire_bytes(3, 5, 40, num_nodes=70_000,
                                    max_edges=1 << 16, **kw)


# -------------------------------------------------------- plan and CLI ------

def test_plan_pads_the_vertex_axis_and_refuses_what_is_not_ported(
        monkeypatch):
    plan = ExecutionPlan(shards=4)
    plan.validate()
    msgs = []
    assert plan.padded_num_nodes(46, log_fn=msgs.append) == 48
    assert "46 -> 48" in msgs[0]
    assert plan.padded_num_nodes(48) == 48
    assert ExecutionPlan().padded_num_nodes(46) == 46
    with pytest.raises(ValueError, match="auto_pad"):
        ExecutionPlan(shards=4, auto_pad=False).padded_num_nodes(46)
    ExecutionPlan(shards=4, a2a_chunks=2).validate()
    with pytest.raises(ValueError, match="a2a_chunks"):
        ExecutionPlan(a2a_chunks=2).validate()
    with pytest.raises(ValueError, match="mesh_axis"):
        ExecutionPlan(shards=4, mesh_axis="model").validate()
    # P > 1 needs a group of P ranks; it names how to launch one
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        plan.build_mesh()
    rc = RunConfig(model=_engine_cfg("tmgcn"), data=_engine_data("tmgcn"),
                   plan=plan, log_fn=_silent)
    with pytest.raises(ValueError, match="torchrun"):
        Engine(rc, device="cpu").resolve()
    # compression, the distributed stream and its wire run (held to JAX in
    # tests/test_torch_dist_stream.py); the int8 block body needs its
    # residuals
    cfg = _engine_cfg("tmgcn")
    with pytest.raises(ValueError, match="comm_residuals"):
        partition.snapshot_block_body(cfg, None, None, [], (), [],
                                      compression="int8_a2a")
    ExecutionPlan(mode="streamed_mesh", shards=4,
                  compression="int8_a2a").validate()
    assert len(data.DTDGPipeline(_engine_data("tmgcn").build(), nb=NB,
                                 device="cpu").sharded_streams(4)) == 4
    # NCCL runs one rank per card: too few cards refuse, naming both counts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="4 visible CUDA devices.*1 "
                                           "visible"):
        Engine(rc)


def test_torchrun_launcher_trains_on_two_ranks():
    """``torchrun --standalone --nproc-per-node 2 -m
    repro_torch.launch.train --data-parallel 2 --device cpu``: both ranks
    train, rank 0 alone prints the reference's ``done:`` line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "paper_dyngnn", "--data-parallel", "2", "--steps", "4",
         "--a2a-chunks", "2", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    done = [ln for ln in out.stdout.splitlines() if ln.startswith("done:")]
    assert len(done) == 1, out.stdout
    assert done[0].startswith("done: 4 steps, final loss ")
    assert "link-pred acc " in done[0]


def test_launcher_without_torchrun_names_how_to_launch():
    from repro_torch.launch import train as launch_train
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        launch_train.main(["--arch", "tmgcn", "--device", "cpu",
                           "--data-parallel", "2"])
    with pytest.raises(SystemExit, match="a2a_chunks"):
        launch_train.main(["--arch", "tmgcn", "--device", "cpu",
                           "--a2a-chunks", "2"])


@pytest.mark.parametrize("model", MODELS)
def test_init_carries_take_the_ranks_vertex_rows(model):
    """``init_carries(num_local_nodes=n)`` holds n vertex rows (a rank's
    N / P), all N by default; EvolveGCN's weight carry has none."""
    cfg, _, _ = _setup(model)
    params = tm.init_params(torch.Generator().manual_seed(0), cfg)
    for n, rows in ((None, N), (N // P, N // P)):
        for c in tm.init_carries(cfg, params, num_local_nodes=n):
            if model == "tmgcn":
                assert c.shape == (W - 1, rows, 6)
            elif model == "cdgcn":
                assert c[0].shape == c[1].shape == (rows, 6)
            else:
                assert c[1][0].shape[0] == 6
