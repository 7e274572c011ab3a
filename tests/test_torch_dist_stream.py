"""The distributed stream (paper §3.2 x §4.2) in the port, on 4 gloo ranks,
held to the JAX package's ``train_distributed_streamed`` on 4 host
devices.

One pool of 4 rank processes per module (``pool``) runs every case on the
CPU and writes each rank's results to ``tmp_path``; the tests below read
them and compare with the JAX package, computed here in the parent.  The
ranks are started with the spawn method and import this module for its
rank program, so the module imports no JAX at its top: the JAX side is
the ``jx`` fixture's.  Sizes are ``tests/test_dist_stream.py``'s (N = 48,
T = 16, nb 2, window 3): rounds of 8 snapshots, 2 a rank at P = 4; the
JAX side runs at data = 4 where its own test uses 8.

* the loss stream and final parameters against JAX's, all three models
  (rtol 1e-5, parameters atol 1e-6), and against the port's single-device
  ``train_streamed(slice_len=8)``; the ranks' parameters bit-identical;
* the ``a2a_chunks`` x ``pipeline_rounds`` matrix against the serial run
  (rtol 1e-5), overlap on / off identical, ``compression="none"``
  identical to leaving it out;
* ``int8_a2a`` across the matrix and ``int8_all`` (tmgcn, cdgcn) within
  ``DRIFT_ATOL`` (``tests/test_compression_drift.py``) of ``none`` and
  within ``INT8_VS_JAX`` of the JAX compressed run; each round handed the
  residuals the round before returned, and a run that drops them outside
  that bound; EvolveGCN under ``int8_a2a`` bit-exact;
* the quantizer's int8 codes and scales equal JAX's; the residual ledger
  of the quantized all-to-all exact; ``compressed_psum``'s error-feedback
  identity;
* a round's forward bytes equal ``alltoall_round_payload`` at P = 2 and
  4, f32 and int8, 1 and 2 chunks; the whole round sends 2.0 times them;
* the per-rank payload shrinking with P; the narrow wire decoding as
  JAX's; the copied ``wire``, ``sharded``, ``overlap`` and
  ``dyngnn_elastic_blocks`` byte-identical to the reference;
* ``Engine(mode="streamed_mesh", shards=4)`` against the JAX Engine; the
  plan's rules and refusals; launch and CSR-build counts a round at P = 1
  and 4; and the ``torchrun`` launcher on 2 ranks.
"""

import datetime
import functools
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
from repro_torch.core import dtdg
from repro_torch.core import models as tm
from repro_torch.core import partition
from repro_torch.data import dyngnn as data
from repro_torch.dist import comm_volume as cv
from repro_torch.dist import compression, overlap
from repro_torch.dist import sharding
from repro_torch.ft import elastic
from repro_torch.ft.straggler import StepTimer
from repro_torch.kernels.mproduct import ops as mp_ops
from repro_torch.kernels.segment_spmm import ops as spmm_ops
from repro_torch.optim import adamw
from repro_torch.run import (CheckpointSpec, Engine, ExecutionPlan,
                             RunConfig, SyntheticTrace)
from repro_torch.stream import distributed as sd
from repro_torch.stream import encoder as enc
from repro_torch.stream import prefetch
from repro_torch.stream import sharded
from repro_torch.stream import train_loop as tl
from repro_torch.stream import wire

ROOT = Path(__file__).resolve().parents[1]
P = 4
N, T, NB, W = 48, 16, 2, 3
WIN = T // NB
EPOCHS = 2
ENGINE_N = 46
MODELS = ["tmgcn", "cdgcn", "evolvegcn"]
SMOOTH = {"tmgcn": "mproduct", "evolvegcn": "edgelife", "cdgcn": "none"}
DRIFT_ATOL = 1e-3       # tests/test_compression_drift.py:43
# The port against the JAX package under int8, set from the readings of
# ``print_int8_readings`` (the end of this file) over the data and
# parameter seeds 0-3: CD-GCN within 2.6e-7 relative (f32 rounding);
# TM-GCN within 3.5e-5 absolute, because its f32 noise flips int8 codes,
# each a whole quantization step: a 2e-7 relative nudge of its parameters
# alone moves its int8 losses by up to 4.5e-5 and its f32 losses by at
# most 6e-8.  Dropping the error feedback between rounds moves CD-GCN's
# losses 5.1e-6 to 2.5e-5 from JAX's.
INT8_VS_JAX = {"tmgcn": {"atol": 1e-4}, "cdgcn": {"rtol": 2e-6}}
MATRIX = [(c, pr) for c in (1, 2) for pr in (False, True)]
POOL_DEADLINE_S = 150


# ------------------------------------------------------- the rank program ---

def _silent(_msg):
    return None


def _ds(model):
    """``tests/test_dist_stream.py::_ds`` in the port (its numpy copies)."""
    ds = data.synthetic_dataset(N, T, density=2.0, churn=0.1,
                                smoothing_mode=SMOOTH[model], window=W,
                                seed=0)
    cfg = tm.DynGNNConfig(model=model, num_nodes=N, num_steps=T, window=W,
                          checkpoint_blocks=NB)
    return cfg, ds


def _train(group, jparams, model, **kw):
    cfg, ds = _ds(model)
    st = sd.train_distributed_streamed(
        cfg, ds.snapshots, ds.values, ds.frames, ds.labels, mesh=group,
        num_epochs=EPOCHS, params=convert.params_from_jax(jparams[model]),
        device="cpu", **kw)
    return {"losses": st.losses, "params": convert.params_to_numpy(st.params),
            "per_shard_bytes": st.per_shard_bytes}


def _counters():
    return dict(obs.metrics_snapshot()["counters"])


def _a2a_delta(before):
    now = _counters()
    return {k: now.get(k, 0) - before.get(k, 0) for k in
            ("partition.a2a_calls", "partition.a2a_bytes",
             "partition.a2a_remote_bytes")}


def _case_train(rank, group, jparams):
    out = {m: _train(group, jparams, m) for m in MODELS}
    out["tmgcn-sync"] = _train(group, jparams, "tmgcn", overlap=False)
    out["tmgcn-depth3"] = _train(group, jparams, "tmgcn", prefetch_depth=3)
    out["tmgcn-none"] = _train(group, jparams, "tmgcn", compression="none")
    for c, pr in MATRIX:
        for comp in ("none", "int8_a2a"):
            if (c, pr, comp) != (1, False, "none"):
                out[f"tmgcn-{comp}-{c}-{pr}"] = _train(
                    group, jparams, "tmgcn", a2a_chunks=c,
                    pipeline_rounds=pr, compression=comp)
    for model in ("tmgcn", "cdgcn"):
        out[f"{model}-int8_all"] = _train(group, jparams, model,
                                          compression="int8_all")
    out["evolvegcn-int8_a2a"] = _train(group, jparams, "evolvegcn",
                                       compression="int8_a2a")
    return out


def _opt_cfg():
    """The trainer's default AdamW at this size."""
    return adamw.AdamWConfig(lr=1e-2, warmup_steps=10,
                             total_steps=EPOCHS * T, weight_decay=0.0)


def _case_residuals(rank, group, jparams):
    """TM-GCN under ``int8_a2a`` with 2 chunks and pipelined rounds,
    through a step that records, each round, whether the residuals it is
    handed are zeros or what the previous round returned, and whether
    those it returns are nonzero; and CD-GCN under ``int8_all`` through a
    step handed fresh zeros every round (error feedback dropped)."""
    cfg, ds = _ds("tmgcn")
    step = sd.make_dist_stream_step(cfg, group, _opt_cfg(), a2a_chunks=2,
                                    compression="int8_a2a")
    chain, last = [], []

    def spy(params, opt_state, carries, comm_res, *rest):
        handed = [t.clone() for pair in comm_res for t in pair]
        out = step(params, opt_state, carries, comm_res, *rest)
        returned = [t.clone() for pair in out[3] for t in pair]
        chain.append({
            "zeros": not any(t.any() for t in handed),
            "carried": len(last) == len(handed) > 0 and all(
                torch.equal(a, b) for a, b in zip(last, handed)),
            "nonzero": all(t.any() for t in returned)})
        last[:] = returned
        return out

    st = sd.train_distributed_streamed(
        cfg, ds.snapshots, ds.values, ds.frames, ds.labels, mesh=group,
        num_epochs=EPOCHS, params=convert.params_from_jax(jparams["tmgcn"]),
        opt_cfg=_opt_cfg(), a2a_chunks=2, pipeline_rounds=True,
        compression="int8_a2a", step_fn=spy, device="cpu")
    cfg, ds = _ds("cdgcn")
    step_c = sd.make_dist_stream_step(cfg, group, _opt_cfg(),
                                      compression="int8_all")

    def reset(params, opt_state, carries, _comm_res, *rest):
        return step_c(params, opt_state, carries,
                      sd.init_comm_residuals(cfg, WIN, group), *rest)

    dropped = sd.train_distributed_streamed(
        cfg, ds.snapshots, ds.values, ds.frames, ds.labels, mesh=group,
        num_epochs=EPOCHS, params=convert.params_from_jax(jparams["cdgcn"]),
        opt_cfg=_opt_cfg(), compression="int8_all", step_fn=reset,
        device="cpu")
    return {"chain": chain, "losses": st.losses,
            "dropped": dropped.losses}


def _round_block(layout, model, jparams):
    """Block 0 of the rank's steps: (cfg, params, blk, csr pairs)."""
    cfg, ds = _ds(model)
    batch = dtdg.build_batch(ds.snapshots, ds.frames, N, values=ds.values,
                             device="cpu")
    fr, ed, ew = (layout.local(a)[0] for a in
                  partition.blockify_batch(batch, NB))
    csrs = [spmm_ops.build_csr_pair(e, w, N) for e, w in zip(ed, ew)]
    return cfg, convert.params_from_jax(jparams[model]), (fr, ed, ew, 0), \
        csrs


def _case_bytes(rank, group, jparams):
    """A round's forward all-to-all bytes (no gradient) and a whole
    round's (the step: forward and backward) on ``group``."""
    p = sharding.group_size(group)
    layout = sharding.ShardLayout.of(group, NB, WIN, N)
    out = {}
    for model in MODELS:
        cfg, params, blk, csrs = _round_block(layout, model, jparams)
        for comp in ("none", "int8_a2a"):
            for chunks in (1, 2):
                carries = sd.init_sharded_carries(cfg, params, group)
                res = (sd.init_comm_residuals(cfg, WIN, group)
                       if comp != "none" else None)
                before = _counters()
                with torch.no_grad():
                    partition.snapshot_block_body(
                        cfg, params, group, carries, blk, csrs,
                        a2a_chunks=chunks, compression=comp,
                        comm_residuals=res)
                out[(model, comp, chunks, "forward")] = _a2a_delta(before)
        for comp in ("none", "int8_a2a"):
            cfg, ds = _ds(model)
            step = sd.make_dist_stream_step(
                cfg, group, adamw.AdamWConfig(total_steps=1),
                compression=comp)
            fr = torch.from_numpy(ds.frames[rank * WIN // p:
                                            (rank + 1) * WIN // p])
            lab = torch.from_numpy(ds.labels[rank * WIN // p:
                                             (rank + 1) * WIN // p])
            pipe = data.DTDGPipeline(ds, nb=NB, device="cpu")
            stream = pipe.sharded_streams(p, rank=rank)[0]
            applier = prefetch.DeltaApplier(pipe.max_edges, "cpu")
            blk = sd.consume_round(
                prefetch.stage_item(tuple(stream[:WIN // p]), "cpu"),
                applier, prefetch.SlotStacker(WIN // p))
            res = (sd.init_comm_residuals(cfg, WIN, group)
                   if comp != "none" else None)
            before = _counters()
            step(params, adamw.init_state(params),
                 sd.init_sharded_carries(cfg, params, group), res, fr, *blk,
                 lab, 0)
            out[(model, comp, 1, "round")] = _a2a_delta(before)
    return out


def _case_ledger(rank, group, jparams):
    """One quantized T -> N all-to-all of ``y + res`` and the plain one of
    what the ledger says was sent; the backward against the transposed
    quantized all-to-all of the cotangent."""
    rng = np.random.default_rng(3 + rank)
    shape = (2, N, 4)
    y = torch.from_numpy((rng.normal(size=shape) * 2.0).astype(np.float32))
    res = torch.from_numpy((rng.normal(size=shape) * 0.01).astype(
        np.float32))
    y.requires_grad_(True)
    out, new_res = compression.quantized_t_to_n(y, res, group)
    w = torch.from_numpy(rng.normal(size=tuple(out.shape)).astype(
        np.float32))
    (out * w).sum().backward()
    with torch.no_grad():
        plain = sharding.t_to_n(y + res - new_res, group)
        bwd = sharding.n2t_recv(compression.quantized_all_to_all(
            sharding.n2t_send(w, P), group))
    g = np.random.default_rng(7).normal(size=(P, 32)).astype(np.float32)
    res0 = np.zeros((32,), np.float32)
    red, res1 = compression.compressed_psum(
        {"g": torch.from_numpy(g[rank]), "l": [torch.ones(3) * 2]}, group,
        {"g": torch.from_numpy(res0), "l": [torch.zeros(3)]})
    return {"out": out.detach().numpy(), "plain": plain.numpy(),
            "y": y.detach().numpy(), "res": res.numpy(),
            "new_res": new_res.numpy(), "new_res_grad": new_res.requires_grad,
            "grad": y.grad.numpy(), "bwd": bwd.numpy(), "g": g,
            "red": red["g"].numpy(), "red_l": red["l"][0].numpy(),
            "res1": res1["g"].numpy(), "res1_l": res1["l"][0].numpy()}


def _case_engine(rank, group, jparams):
    out = {}
    for model in MODELS:
        cfg = tm.DynGNNConfig(model=model, num_nodes=ENGINE_N, num_steps=T,
                              window=W, checkpoint_blocks=NB)
        trace = SyntheticTrace(num_nodes=ENGINE_N, num_steps=T, density=2.0,
                               churn=0.1, smoothing_mode=SMOOTH[model],
                               window=W)
        eng = Engine(RunConfig(model=cfg, data=trace, plan=ExecutionPlan(
            mode="streamed_mesh", shards=P, num_epochs=EPOCHS,
            pipeline_rounds=True), log_fn=_silent),
            params=convert.params_from_jax(jparams[f"engine-{model}"]),
            device="cpu")
        res = eng.fit()
        rr = eng.resolve()
        out[model] = {"losses": res.losses,
                      "params": convert.params_to_numpy(res.state.params),
                      "per_shard_bytes": res.per_shard_bytes,
                      "num_nodes": rr.cfg.num_nodes, "step": res.state.step,
                      "pipeline_rounds": res.pipeline_rounds,
                      "compression": res.compression,
                      "rounds": res.metrics["counters"].get("stream.rounds"),
                      "payload": res.metrics["counters"].get(
                          "stream.payload_bytes")}
    return out


def _case_launches(rank, groups, jparams):
    """Kernel launches (their plain versions, reached through the same
    wrappers) and CSR builds of one epoch of TM-GCN rounds, on a one-rank
    group and on the 4 ranks."""
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
        for label, group in groups.items():
            for key in calls:
                calls[key] = 0
            spmm_ops.csr_builds = 0
            sd.train_distributed_streamed(
                cfg, ds.snapshots, ds.values, ds.frames, ds.labels,
                mesh=group, params=convert.params_from_jax(
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
        pair = dist.new_group([0, 1])
        singles = [dist.new_group([r]) for r in range(P)]
        res = {"train": _case_train(rank, world, jparams),
               "bytes": _case_bytes(rank, world, jparams),
               "bytes_p2": (_case_bytes(rank, pair, jparams) if rank < 2
                            else None),
               "ledger": _case_ledger(rank, world, jparams),
               "residuals": _case_residuals(rank, world, jparams),
               "engine": _case_engine(rank, world, jparams),
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

    from repro.core import models as jm
    from repro.core.graphdiff import SnapshotDelta as JDelta
    from repro.data import dyngnn as jdata
    from repro.dist import compression as jcomp
    from repro.dist import overlap as joverlap
    from repro.ft import elastic as jelastic
    from repro.launch.mesh import make_host_mesh
    from repro.run import Engine as JEngine
    from repro.run import ExecutionPlan as JPlan
    from repro.run import RunConfig as JRunConfig
    from repro.run import SyntheticTrace as JTrace
    from repro.stream import distributed as jsd
    from repro.stream import encoder as jenc
    from repro.stream import prefetch as jprefetch
    from repro.stream import sharded as jsharded
    from repro.stream import wire as jwire
    return types.SimpleNamespace(**locals())


def _jcfg(jx, model, n=N):
    return jx.jm.DynGNNConfig(model=model, num_nodes=n, num_steps=T,
                              window=W, checkpoint_blocks=NB)


def _jds(jx, model):
    ds = jx.jdata.synthetic_dataset(N, T, density=2.0, churn=0.1,
                                    smoothing_mode=SMOOTH[model], window=W,
                                    seed=0)
    return _jcfg(jx, model), ds


@pytest.fixture(scope="module")
def jparams(jx):
    """Each model's JAX parameters (``PRNGKey(0)``, the JAX trainer's and
    Engine's seed-0 init) as numpy trees, at N = 48 and at the Engine's
    N = 46 (padded to 48: the parameters do not depend on N)."""
    out = {}
    for m in MODELS:
        for key, n in ((m, N), (f"engine-{m}", ENGINE_N)):
            out[key] = jx.jax.tree.map(np.asarray, jx.jm.init_params(
                jx.jax.random.PRNGKey(0), _jcfg(jx, m, n)))
    return out


@pytest.fixture(scope="module")
def pool(tmp_path_factory, jparams):
    """Every case on 4 gloo ranks -> [rank 0's results, ..., rank 3's]."""
    d = tmp_path_factory.mktemp("dist_stream")
    run_ranks(_rank_main, P, (str(d / "store"), str(d), jparams),
              POOL_DEADLINE_S)
    out = []
    for r in range(P):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def jruns(jx):
    """The JAX distributed stream at data = 4: ``none`` for every model,
    ``int8_a2a`` for tmgcn with 1 and 2 chunks (each chunk has its own
    scales) and ``int8_all`` for tmgcn and cdgcn."""
    mesh = jx.make_host_mesh(data=P, model=1)
    out = {}
    for model, comp, chunks in ([(m, "none", 1) for m in MODELS]
                                + [("tmgcn", "int8_a2a", 1),
                                   ("tmgcn", "int8_a2a", 2),
                                   ("tmgcn", "int8_all", 1),
                                   ("cdgcn", "int8_all", 1)]):
        cfg, ds = _jds(jx, model)
        run = jx.jsd.train_distributed_streamed(
            cfg, ds.snapshots, ds.values, np.asarray(ds.frames),
            np.asarray(ds.labels), mesh=mesh, num_epochs=EPOCHS,
            compression=comp, a2a_chunks=chunks)
        out[(model, comp) if chunks == 1 else (model, comp, chunks)] = run
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


def _assert_items_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in a.__dataclass_fields__:
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f
            np.testing.assert_array_equal(va, vb)
        else:
            assert type(va) is type(vb) and va == vb, f


# ------------------------------------------------- loss streams vs JAX ------

@pytest.mark.parametrize("model", MODELS)
def test_loss_stream_and_params_match_jax(pool, jx, jruns, model):
    """Same trace, same parameters: the 4 ranks' loss stream within 1e-5
    relative of the JAX trainer's on 4 host devices, the final parameters
    within 1e-6, bit-identical across the ranks; the per-rank payloads
    are the JAX shards' exactly."""
    got = _same_on_every_rank(pool, model)
    want = jruns[(model, "none")]
    assert len(got["losses"]) == len(want.losses) == EPOCHS * NB
    np.testing.assert_allclose(got["losses"], want.losses, rtol=1e-5)
    jp = _named(jx, want.params)
    assert got["params"].keys() == jp.keys()
    for k, v in got["params"].items():
        np.testing.assert_allclose(v, jp[k], atol=1e-6, err_msg=k)
    assert got["per_shard_bytes"] == list(want.per_shard_bytes)


@pytest.mark.parametrize("model", MODELS)
def test_matches_the_single_device_slice_stream(pool, jparams, model):
    """The port's own reference: ``train_streamed(slice_len=8)`` on one
    device, the same slices and AdamW cadence (rtol 1e-5, atol 1e-6)."""
    cfg, ds = _ds(model)
    ref = tl.train_streamed(
        cfg, ds.snapshots, ds.values, ds.frames, ds.labels,
        num_epochs=EPOCHS, overlap=False, slice_len=WIN,
        params=convert.params_from_jax(jparams[model]), device="cpu")
    got = pool[0]["train"][model]
    np.testing.assert_allclose(got["losses"], ref.losses, rtol=1e-5)
    for k, v in convert.params_to_numpy(ref.params).items():
        np.testing.assert_allclose(got["params"][k], v, atol=1e-6,
                                   err_msg=k)


# ------------------------------------------------------ schedule knobs ------

@pytest.mark.parametrize("chunks,pipelined", MATRIX[1:])
def test_chunks_and_pipelined_rounds_match_the_serial_run(pool, chunks,
                                                          pipelined):
    serial = pool[0]["train"]["tmgcn"]
    got = _same_on_every_rank(pool, f"tmgcn-none-{chunks}-{pipelined}")
    np.testing.assert_allclose(got["losses"], serial["losses"], rtol=1e-5)
    for k, v in got["params"].items():
        np.testing.assert_allclose(v, serial["params"][k], atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("key", ["tmgcn-sync", "tmgcn-depth3",
                                 "tmgcn-none"])
def test_overlap_depth_and_compression_none_are_bit_identical(pool, key):
    """The prefetch thread on or off (or 3 deep), and
    ``compression="none"`` against leaving the argument out: the same
    losses and parameters, bit for bit."""
    base = pool[0]["train"]["tmgcn"]
    got = _same_on_every_rank(pool, key)
    assert got["losses"] == base["losses"]
    for k, v in got["params"].items():
        np.testing.assert_array_equal(v, base["params"][k], err_msg=k)


# ---------------------------------------------------------- compression -----

@pytest.mark.parametrize("chunks,pipelined", MATRIX)
def test_int8_a2a_drift_bounded_across_the_matrix(pool, jruns, chunks,
                                                  pipelined):
    """``int8_a2a`` within DRIFT_ATOL of the uncompressed run, and within
    INT8_VS_JAX of the JAX ``int8_a2a`` run with as many chunks, on every
    (a2a_chunks, pipeline_rounds)."""
    got = _same_on_every_rank(pool, f"tmgcn-int8_a2a-{chunks}-{pipelined}")
    base = pool[0]["train"]["tmgcn"]
    np.testing.assert_allclose(got["losses"], base["losses"],
                               atol=DRIFT_ATOL)
    want = jruns[("tmgcn", "int8_a2a") if chunks == 1
                 else ("tmgcn", "int8_a2a", chunks)]
    np.testing.assert_allclose(got["losses"], want.losses,
                               **INT8_VS_JAX["tmgcn"])
    assert got["losses"] != base["losses"]        # the wire was quantized


@pytest.mark.parametrize("model", ["tmgcn", "cdgcn"])
def test_int8_all_drift_bounded_and_shrinks_the_stream(pool, jruns, model):
    got = _same_on_every_rank(pool, f"{model}-int8_all")
    base = pool[0]["train"][model]
    want = jruns[(model, "int8_all")]
    np.testing.assert_allclose(got["losses"], base["losses"],
                               atol=DRIFT_ATOL)
    np.testing.assert_allclose(got["losses"], want.losses,
                               **INT8_VS_JAX[model])
    assert got["per_shard_bytes"] == list(want.per_shard_bytes)
    assert sum(got["per_shard_bytes"]) < sum(base["per_shard_bytes"])


def test_each_round_gets_the_residuals_the_last_one_returned(pool):
    """Error feedback crosses rounds: the first round of each epoch is
    handed zeros, every later one exactly what the round before it
    returned (with 2 chunks and pipelined rounds), and every round returns
    a nonzero residual; the spy changes no loss."""
    for r in pool:
        chain = r["residuals"]["chain"]
        assert len(chain) == EPOCHS * NB
        for i, c in enumerate(chain):
            first = i % NB == 0
            assert c["zeros"] == first and c["carried"] != first, i
            assert c["nonzero"], i
        assert r["residuals"]["losses"] == \
            pool[0]["train"]["tmgcn-int8_a2a-2-True"]["losses"]


def test_dropping_error_feedback_leaves_the_jax_bound(pool, jruns):
    """A CD-GCN ``int8_all`` run whose step is handed fresh zeros every
    round falls outside INT8_VS_JAX of the JAX run that the real one
    meets, so that bound would catch feedback lost between rounds."""
    want = np.asarray(jruns[("cdgcn", "int8_all")].losses)
    dropped = np.asarray(pool[0]["residuals"]["dropped"])
    np.testing.assert_allclose(pool[0]["train"]["cdgcn-int8_all"]["losses"],
                               want, **INT8_VS_JAX["cdgcn"])
    # round 0 is handed zeros either way
    np.testing.assert_allclose(dropped[0], want[0], **INT8_VS_JAX["cdgcn"])
    assert (np.abs(dropped - want)
            > INT8_VS_JAX["cdgcn"]["rtol"] * np.abs(want)).any()


def test_evolvegcn_int8_a2a_is_bit_exact(pool):
    """EvolveGCN redistributes nothing (§5.5): no residual, nothing on the
    wire to quantize."""
    got = _same_on_every_rank(pool, "evolvegcn-int8_a2a")
    assert got["losses"] == pool[0]["train"]["evolvegcn"]["losses"]
    assert partition.a2a_payload_dims(_ds("evolvegcn")[0]) == []


def _qcases():
    rng = np.random.default_rng(11)
    return [rng.normal(size=(64,)).astype(np.float32) * 3,
            rng.normal(size=(5, 7)).astype(np.float32) * 1e-3,
            np.zeros((9,), np.float32),
            np.asarray([np.inf, -np.inf, 1.0, -1.0], np.float32),
            np.asarray([0.5, 1.5, 2.5, -0.5, 127.0, -127.0], np.float32)]


@pytest.mark.parametrize("case", range(5))
def test_quantize_gives_the_jax_codes_and_scales(jx, case):
    x = _qcases()[case]
    q, s = compression.quantize(torch.from_numpy(x))
    jq, js = jx.jcomp.quantize(jx.jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert np.float32(s) == np.asarray(js)
    np.testing.assert_array_equal(
        compression.dequantize(q, s).numpy(),
        np.asarray(jx.jcomp.dequantize(jq, js)))
    res = np.full(x.shape, 0.01, np.float32)
    deq, nr = compression.ef_quantize(torch.from_numpy(x),
                                      torch.from_numpy(res))
    jdeq, jnr = jx.jcomp.ef_quantize(jx.jnp.asarray(x), jx.jnp.asarray(res))
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
    np.testing.assert_array_equal(nr.numpy(), np.asarray(jnr))
    # the wire's host quantizer is the same law
    wq, ws = wire.quantize_values(x)
    np.testing.assert_array_equal(wq, q.numpy())
    assert ws == np.float32(s)


def test_quantize_pieces_is_quantize_per_piece():
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, 3, 5)).astype(np.float32))
    x[2] = 0.0
    q, scales = compression.quantize_pieces(x)
    for i in range(4):
        qi, si = compression.quantize(x[i])
        assert torch.equal(q[i], qi) and scales[i] == si
    assert torch.equal(compression.dequantize_pieces(q, scales)[1],
                       compression.dequantize(q[1], scales[1]))


def test_quantized_all_to_all_keeps_an_exact_ledger(pool):
    """The output IS the plain all-to-all of what the ledger says was sent
    (y + res - new_res), bit for bit: the scales travel with their
    pieces.  The residual is bounded by half a piece's quantization step,
    takes no gradient, and the backward is the transposed quantized
    all-to-all of the cotangent."""
    for r in pool:
        led = r["ledger"]
        np.testing.assert_array_equal(led["out"], led["plain"])
        step = np.abs(led["y"] + led["res"]).max() / 127.0
        assert np.abs(led["new_res"]).max() <= 0.5 * step * (1 + 1e-5)
        assert not led["new_res_grad"]
        np.testing.assert_array_equal(led["grad"], led["bwd"])


def test_compressed_psum_error_feedback_identity(pool):
    """Every rank gets the same mean, and it is the mean of what left the
    residual ledgers: ``mean(g + res0 - res1)``; identical leaves quantize
    exactly."""
    g = pool[0]["ledger"]["g"]
    res1 = np.stack([r["ledger"]["res1"] for r in pool])
    for r in pool:
        np.testing.assert_array_equal(r["ledger"]["red"],
                                      pool[0]["ledger"]["red"])
        np.testing.assert_allclose(r["ledger"]["red_l"], 2.0, atol=1e-5)
        np.testing.assert_array_equal(r["ledger"]["res1_l"], 0.0)
    np.testing.assert_allclose(pool[0]["ledger"]["red"],
                               (g - res1).mean(axis=0), atol=1e-5)
    assert np.abs(res1).max() <= np.abs(g).max() / 127.0


def test_init_residual_keeps_the_tree():
    tree = {"w": torch.ones(2, 3), "b": [torch.ones(2, dtype=torch.float64),
                                         (torch.ones(1),)]}
    res = compression.init_residual(tree)
    assert res.keys() == tree.keys() and isinstance(res["b"][1], tuple)
    assert res["w"].shape == (2, 3) and res["b"][0].dtype == torch.float32
    assert all(float(t.abs().sum()) == 0 for t in compression._flatten(res))


# ---------------------------------------------------------------- bytes ------

def _law(cfg, p, comp, chunks):
    """``alltoall_round_payload`` of one round, each redistribution at its
    own width (cdgcn's T->N payloads are d_in + d_gcn wide)."""
    return sum(cv.alltoall_round_payload(WIN, N, f, 1, p, compression=comp,
                                         a2a_chunks=chunks) / 2
               for dims in partition.a2a_payload_dims(cfg) for f in dims)


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("comp", ["none", "int8_a2a"])
@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("model", MODELS)
def test_round_forward_bytes_equal_the_law(pool, model, p, comp, chunks):
    """Summed over the ranks, a round's forward remote bytes are
    ``alltoall_round_payload(win, N, F, L, P, compression, a2a_chunks)``
    exactly: f32 payloads, or one byte an element plus a (P,) f32 scale
    vector an all-to-all; TM-GCN's law at F = 6 and L = 2 itself."""
    ranks = pool if p == 4 else pool[:2]
    key = "bytes" if p == 4 else "bytes_p2"
    got = [r[key][(model, comp, chunks, "forward")] for r in ranks]
    cfg = _ds(model)[0]
    remote = sum(g["partition.a2a_remote_bytes"] for g in got)
    assert remote == _law(cfg, p, comp, chunks)
    if model == "tmgcn":
        assert remote == cv.alltoall_round_payload(
            WIN, N, 6, 2, p, compression=comp, a2a_chunks=chunks)
    per_a2a = 1 if comp == "none" else 2          # the scale vector's own
    calls = 0 if model == "evolvegcn" else 2 * 2 * chunks * per_a2a
    for g in got:
        assert g["partition.a2a_calls"] == calls


@pytest.mark.parametrize("comp", ["none", "int8_a2a"])
@pytest.mark.parametrize("model", ["tmgcn", "cdgcn"])
def test_a_round_sends_twice_the_forward_law_and_int8_under_point3(
        pool, model, comp):
    """No checkpoint, no recompute: the step's backward sends one
    all-to-all for each of the forward's, at the same width, so the round
    sends exactly 2.0 times the forward law; int8 bytes (scales included)
    are at most 0.3 of f32's (``tests/test_compression_drift.py:145``)."""
    cfg = _ds(model)[0]
    for p, key, ranks in ((4, "bytes", pool), (2, "bytes_p2", pool[:2])):
        rnd = sum(r[key][(model, comp, 1, "round")][
            "partition.a2a_remote_bytes"] for r in ranks)
        assert rnd == 2.0 * _law(cfg, p, comp, 1)
    q = sum(r["bytes"][(model, "int8_a2a", 1, "round")][
        "partition.a2a_bytes"] for r in pool)
    f32 = sum(r["bytes"][(model, "none", 1, "round")][
        "partition.a2a_bytes"] for r in pool)
    assert q <= 0.3 * f32


@pytest.mark.parametrize("p", [2, 4])
def test_per_shard_payload_shrinks_with_p(jx, p):
    """Each rank receives only its own time slices: its payload is under
    the full stream's (``tests/test_dist_stream.py:119``)."""
    cfg, ds = _ds("tmgcn")
    max_edges = enc.padded_max_edges(ds.snapshots)
    full = sum(i.payload_bytes for i in enc.encode_stream_fast(
        ds.snapshots, ds.values, N, max_edges, WIN))
    pipe = data.DTDGPipeline(ds, nb=NB, device="cpu")
    per = [sum(i.payload_bytes for i in s)
           for s in pipe.sharded_streams(p)]
    assert len(per) == p
    for b in per:
        assert b < full
    assert max(per) < 2 * full / p + max_edges * 12
    assert sharded.sharded_stream_bytes(pipe.sharded_streams(p)) == sum(per)


# ------------------------------------------------ copies of the reference ---

@pytest.mark.parametrize("w", ["none", "int8"])
def test_per_rank_streams_are_the_jax_shards(jx, w):
    """``encode_time_sliced`` (every shard, and one rank's alone) and
    ``DTDGPipeline.sharded_streams`` byte-identical to the reference's."""
    for model in MODELS:
        cfg, ds = _ds(model)
        _, jds = _jds(jx, model)
        pipe = data.DTDGPipeline(ds, nb=NB, device="cpu")
        jpipe = jx.jdata.DTDGPipeline(jds, nb=NB)
        for p in (2, 4):
            want = jpipe.sharded_streams(p, wire=w)
            got = pipe.sharded_streams(p, wire=w)
            assert len(got) == len(want) == p
            for r in range(p):
                mine = pipe.sharded_streams(p, wire=w, rank=r)
                assert len(mine) == 1
                for a, b, c in zip(got[r], want[r], mine[0], strict=True):
                    _assert_items_equal(a, b)
                    _assert_items_equal(c, b)
                    assert a.payload_bytes == b.payload_bytes
            assert sharded.sharded_stream_bytes(got) == \
                jx.jsharded.sharded_stream_bytes(want)
    for args in ((16, 8, 4, 1), (20, 8, 2, 0), (7, 4, 4, 3)):
        assert sharded.shard_slice_steps(*args) == \
            jx.jsharded.shard_slice_steps(*args)
    with pytest.raises(ValueError, match="must divide"):
        sharded.shard_slice_steps(16, 6, 4, 0)
    with pytest.raises(ValueError, match="boundary"):
        sharded.encode_time_sliced(ds.snapshots, ds.values, N, 256, WIN, 2,
                                   start_step=3)


def test_wire_is_the_reference(jx):
    from repro_torch.core.graphdiff import SnapshotDelta
    jwire = jx.jwire
    for m in (32767, 32768, 5):
        assert wire.index_dtype(m) == jwire.index_dtype(m)
    for v in _qcases():
        a, b = wire.quantize_values(v), jwire.quantize_values(v)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1] and type(a[1]) is type(b[1])
        with np.errstate(over="ignore"):      # the ±inf case saturates
            np.testing.assert_array_equal(wire.dequantize_values(*a),
                                          jwire.dequantize_values(*b))
    fields = dict(drop_pos=np.asarray([1, 2, 0], np.int32),
                  drop_mask=np.asarray([1.0, 1.0, 0.0], np.float32),
                  add_edges=np.asarray([[3, 4], [0, 0]], np.int32),
                  add_mask=np.asarray([1.0, 0.0], np.float32),
                  values=np.linspace(0, 2, 8).astype(np.float32),
                  num_edges=5)
    for nodes in (100, 40000):
        got = wire.quantize_delta(SnapshotDelta(**fields), nodes, 8)
        want = jwire.quantize_delta(jx.JDelta(**fields), nodes, 8)
        _assert_items_equal(got, want)
        assert got.payload_bytes == want.payload_bytes
    assert wire.validate_wire("int8") == "int8"
    with pytest.raises(ValueError, match="wire must be one of"):
        wire.validate_wire("int4")


def test_int8_wire_decodes_as_the_jax_ring(jx):
    """The narrow stream through the port's ring equals the JAX ring's
    decode (edges, mask and dequantized values, bit for bit); against the
    f32 stream edges and mask are identical and values within half a
    quantization step, and fulls stay lossless."""
    cfg, ds = _ds("tmgcn")
    max_edges = enc.padded_max_edges(ds.snapshots)
    f32 = enc.encode_stream_fast(ds.snapshots, ds.values, N, max_edges, WIN)
    q = enc.encode_stream_fast(ds.snapshots, ds.values, N, max_edges, WIN,
                               wire="int8")
    jq = jx.jenc.encode_stream_fast(ds.snapshots, ds.values, N, max_edges,
                                    WIN, wire="int8")
    kinds = {type(it).__name__ for it in q}
    assert kinds == {"QuantizedDelta", "FullSnapshot"}
    ours = prefetch.DeltaApplier(max_edges, "cpu")
    ref = prefetch.DeltaApplier(max_edges, "cpu")
    theirs = jx.jprefetch.DeltaApplier(max_edges, donate=False)
    for it_f, it_q, it_j in zip(f32, q, jq, strict=True):
        staged = prefetch.stage_item(it_q, "cpu")
        if isinstance(it_q, wire.QuantizedDelta):
            assert staged.drop_pos.dtype == torch.int16
            assert staged.values_q.dtype == torch.int8
        e, m, v = (t.clone() for t in ours.consume(staged))
        ef, mf, vf = ref.consume(prefetch.stage_item(it_f, "cpu"))
        je, jm_, jv = (np.asarray(a) for a in theirs.consume(it_j))
        np.testing.assert_array_equal(e.numpy(), je)
        np.testing.assert_array_equal(m.numpy(), jm_)
        np.testing.assert_array_equal(v.numpy(), jv)
        np.testing.assert_array_equal(e.numpy(), ef.numpy())
        np.testing.assert_array_equal(m.numpy(), mf.numpy())
        if isinstance(it_q, wire.QuantizedDelta):
            step = float(it_q.values_scale)
            assert np.abs(v.numpy() - vf.numpy()).max() <= \
                0.5 * step * (1 + 1e-5)
        else:
            np.testing.assert_array_equal(v.numpy(), vf.numpy())


def test_encoder_int8_wire_is_the_reference(jx):
    cfg, ds = _ds("cdgcn")
    max_edges = enc.padded_max_edges(ds.snapshots)
    got = enc.encode_stream_fast(ds.snapshots, ds.values, N, max_edges, 4,
                                 wire="int8")
    want = jx.jenc.encode_stream_fast(ds.snapshots, ds.values, N, max_edges,
                                      4, wire="int8")
    for a, b in zip(got, want, strict=True):
        _assert_items_equal(a, b)


def test_overlap_models_and_elastic_blocks_are_the_reference(jx):
    for args in ((1.0, 2.0, 1), (3.0, 1.0, 4), (0.0, 0.0, 2)):
        assert overlap.overlap_time_model(*args) == \
            jx.joverlap.overlap_time_model(*args)
    for args, kw in (((0.5, 1.0, 2.0, 1.5), {}),
                     ((0.5, 1.0, 2.0, 1.5), {"chunks": 3}),
                     ((3.0, 1.0, 2.0, 1.5), {"chunks": 2,
                                             "pipeline_rounds": True}),
                     ((0.5, 1.0, 2.0, 1.5), {"a2a_wire_ratio": 0.26})):
        assert overlap.round_time_model(*args, **kw) == \
            jx.joverlap.round_time_model(*args, **kw)
    with pytest.raises(ValueError, match="a2a_wire_ratio"):
        overlap.round_time_model(1, 1, 1, 1, a2a_wire_ratio=0)
    for args in ((16, 4, 8), (16, 4, 2), (32, 4, 16), (12, 3, 5), (8, 8, 1),
                 (16, 1, 16)):
        assert elastic.dyngnn_elastic_blocks(*args) == \
            jx.jelastic.dyngnn_elastic_blocks(*args)
    with pytest.raises(ValueError, match="cannot be tiled"):
        elastic.dyngnn_elastic_blocks(10, 4, 4)
    assert overlap.snapshot_partition_forward_overlapped.__module__ == \
        "repro_torch.dist.overlap"


# ------------------------------------------------------------- Engine -------

@pytest.mark.parametrize("model", MODELS)
def test_engine_on_four_ranks_matches_the_jax_engine(pool, jx, model):
    """``Engine(mode="streamed_mesh", shards=4, pipeline_rounds=True)``:
    N = 46 pads to 48 on both sides; the loss stream within 1e-5 relative
    of the JAX Engine's, the per-rank payloads equal, the knobs echoed,
    and the ranks' parameters bit-identical."""
    want = jx.JEngine(jx.JRunConfig(
        model=_jcfg(jx, model, n=ENGINE_N),
        data=jx.JTrace(num_nodes=ENGINE_N, num_steps=T, density=2.0,
                       churn=0.1, smoothing_mode=SMOOTH[model], window=W),
        plan=jx.JPlan(mode="streamed_mesh", shards=P, num_epochs=EPOCHS,
                      pipeline_rounds=True),
        log_fn=_silent)).fit()
    got = pool[0]["engine"][model]
    assert got["num_nodes"] == 48
    np.testing.assert_allclose(got["losses"], want.losses, rtol=1e-5)
    assert got["per_shard_bytes"] == list(want.per_shard_bytes)
    assert got["step"] == want.state.step == EPOCHS * NB
    assert got["pipeline_rounds"] and got["compression"] == "none"
    assert got["rounds"] == EPOCHS * NB
    for r, res in enumerate(pool):
        e = res["engine"][model]
        assert e["payload"] == got["per_shard_bytes"][r]
        assert e["losses"] == got["losses"]
        for k, v in e["params"].items():
            np.testing.assert_array_equal(v, got["params"][k], err_msg=k)


@pytest.mark.parametrize("label,ranks", [("P1", 1), ("P4", 4)])
def test_launch_and_csr_build_counts_a_round(pool, label, ranks):
    """A TM-GCN round of win = 8 over P ranks, L = 2: per rank, L win/P
    aggregates forward and (L - 1) win/P backward (the frames need no
    gradient), L M-products and L transposed bands (every rank runs the
    temporal stage on its vertices; the detached prefix needs no
    gradient), 2 win/P CSR builds.  At P = 1 these are the streamed
    ``slice_len = 8`` step's counts, which ``chip_smoke.py`` checks on the
    card (24 / 2 / 2 and 16)."""
    bsl = WIN // ranks
    for r in pool:
        got = r["launches"][label]
        assert got["per_round"] == {"spmm": 3 * bsl, "ttm": 2, "ttm_t": 2}
        assert got["csr_builds"] == 2 * bsl


# -------------------------------------------------------- plan and CLI ------

def test_plan_rules_for_the_distributed_stream(jx):
    ExecutionPlan(mode="streamed_mesh", shards=4, compression="int8_a2a",
                  pipeline_rounds=True, a2a_chunks=2).validate()
    for kw, match in (({"pipeline_rounds": True}, "pipeline_rounds"),
                      ({"compression": "int8_a2a"}, "compression"),
                      ({"mode": "streamed", "compression": "int8_all"},
                       "compression"),
                      ({"mode": "streamed_mesh", "compression": "int9"},
                       "compression"),
                      ({"mode": "streamed_mesh", "compression": "int8_a2a",
                        "rescale": ((1, 2),)}, "elastic"),
                      ({"mode": "streamed_mesh", "rescale": ((0, 2),)},
                       "block 1"),
                      ({"rescale": ((1, 2),)}, "streamed_mesh")):
        with pytest.raises(ValueError, match=match):
            ExecutionPlan(**kw).validate()
    for kw in ({"rescale": ((1, 2),)}, {"rescale_on_preempt": 2}):
        # the elastic knobs validate, and pad N, as the reference's do
        ExecutionPlan(mode="streamed_mesh", shards=4, **kw).validate()
        jx.JPlan(mode="streamed_mesh", shards=4, **kw).validate()
        for n in (48, 50, 53):
            assert ExecutionPlan(mode="streamed_mesh", shards=4,
                                 **kw).padded_num_nodes(n) == \
                jx.JPlan(mode="streamed_mesh", shards=4,
                         **kw).padded_num_nodes(n)
    msgs = []
    for t, nb, p in ((16, 8, 4), (16, 2, 4), (32, 4, 8), (12, 4, 3),
                     (16, 3, 2), (16, 1, 1)):
        for mode in ("streamed_mesh", "eager"):
            got = ExecutionPlan(mode=mode, shards=p).resolved_blocks(
                t, nb, log_fn=msgs.append)
            want = jx.JPlan(mode=mode, shards=p).resolved_blocks(t, nb)
            assert got == want, (t, nb, p, mode)
    assert any("re-blocking" in m for m in msgs)
    with pytest.raises(ValueError, match="cannot be sliced"):
        ExecutionPlan(mode="streamed_mesh", shards=3).resolved_blocks(16, 2)


def test_engine_and_trainer_refuse_what_waits_for_item_8():
    """What waited for item 8 runs now: a CheckpointSpec is taken (and the
    plan still needs its group), and the elastic entry of
    ``train_distributed_streamed`` resumes one epoch segment (the
    reference's refusal for more), stops where ``stop_fn`` says and
    times every round (a one-rank gloo group)."""
    cfg, ds = _ds("tmgcn")
    trace = SyntheticTrace(num_nodes=N, num_steps=T)
    plan = ExecutionPlan(mode="streamed_mesh", shards=4)
    with pytest.raises(ValueError, match="--stream --mesh 4"):
        Engine(RunConfig(model=cfg, data=trace, plan=plan,
                         checkpoint=CheckpointSpec("d")), device="cpu") \
            .resolve()
    with pytest.raises(ValueError, match="--stream --mesh 4"):
        Engine(RunConfig(model=cfg, data=trace, plan=plan), device="cpu") \
            .resolve()
    run = functools.partial(sd.train_distributed_streamed, cfg, ds.snapshots,
                            ds.values, ds.frames, ds.labels,
                            block_size=WIN, device="cpu")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        for kw in ({"start_round": 1}, {"carries": []}):
            with pytest.raises(ValueError, match="one epoch segment"):
                run(mesh=dist.group.WORLD, num_epochs=2, **kw)
        stopped = run(mesh=dist.group.WORLD, num_epochs=2, stop_fn=bool)
        timer = StepTimer()
        tail = run(mesh=dist.group.WORLD, start_round=1, step_timer=timer)
        whole = run(mesh=dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    assert len(stopped.losses) == 2            # stop_fn(1) is True
    assert timer.step_idx == len(tail.losses) == T // WIN - 1
    assert stopped.losses == whole.losses[:2]
    with pytest.raises(ValueError, match="a2a_chunks"):
        sd.make_dist_stream_step(cfg, None, adamw.AdamWConfig(),
                                 a2a_chunks=0)
    with pytest.raises(ValueError, match="comm_residuals"):
        partition.snapshot_block_body(cfg, None, None, [], (), [],
                                      compression="int8_a2a")
    with pytest.raises(ValueError, match="composes"):
        partition.snapshot_block_body(cfg, None, None, [], (), [],
                                      compression="int8_a2a",
                                      fused_labels=True, comm_residuals=[])


@pytest.mark.parametrize("flags,match", [
    (["--stream", "--mesh", "2"], "torchrun --nproc-per-node 2"),
    (["--mesh", "2"], "requires --stream"),
    (["--stream", "--pipeline-rounds"], "pipeline_rounds"),
    (["--stream", "--compression", "int8_a2a"], "compression"),
    (["--stream", "--mesh", "2", "--rescale-at", "1:1"],
     "process group of 2 ranks"),
    (["--stream", "--mesh", "2", "--trace", "t.json"], "item 8c")])
def test_launcher_refusals_for_the_distributed_stream(flags, match):
    from repro_torch.launch import train as launch_train
    with pytest.raises(SystemExit, match=match):
        launch_train.main(["--arch", "tmgcn", "--device", "cpu", *flags])


def test_torchrun_launcher_streams_on_two_ranks():
    """``torchrun --standalone --nproc-per-node 2 -m
    repro_torch.launch.train --stream --mesh 2 --pipeline-rounds
    --compression int8_a2a --device cpu``: both ranks train, rank 0 alone
    prints the reference's summary line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "paper_dyngnn", "--stream", "--mesh", "2",
         "--pipeline-rounds", "--compression", "int8_a2a", "--device",
         "cpu"], capture_output=True, text=True, timeout=120, env=env,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    done = [ln for ln in out.stdout.splitlines()
            if ln.startswith("streamed ")]
    assert len(done) == 1, out.stdout
    assert " block rounds on 2 shards, final loss " in done[0]
    assert "per-device stream " in done[0] and "of naive)" in done[0]
    assert done[0].endswith(", compression int8_a2a")


# ------------------------------------- readings behind INT8_VS_JAX ----------

READING_SEEDS = (0, 1, 2, 3)
READING_RUNS = {                  # label -> (compression, a2a_chunks, how)
    "none": ("none", 1, "plain"), "int8_a2a": ("int8_a2a", 1, "plain"),
    "int8_a2a C=2": ("int8_a2a", 2, "plain"),
    "int8_all": ("int8_all", 1, "plain"),
    "int8_a2a, feedback dropped": ("int8_a2a", 1, "reset"),
    "int8_a2a, nudged": ("int8_a2a", 1, "nudge"),
    "none, nudged": ("none", 1, "nudge")}


def _readings_rank(rank, store_path, out_path, jparams):
    """The port's side of the readings, every seed, model and run."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, P),
                            rank=rank, world_size=P,
                            timeout=datetime.timedelta(seconds=60))
    group, out = dist.group.WORLD, {}
    try:
        for seed in READING_SEEDS:
            for model in ("tmgcn", "cdgcn"):
                ds = data.synthetic_dataset(
                    N, T, density=2.0, churn=0.1,
                    smoothing_mode=SMOOTH[model], window=W, seed=seed)
                cfg = _ds(model)[0]
                for label, (comp, chunks, how) in READING_RUNS.items():
                    params = convert.params_from_jax(jparams[(seed, model)])
                    step = sd.make_dist_stream_step(
                        cfg, group, _opt_cfg(), a2a_chunks=chunks,
                        compression=comp)
                    if how == "reset":
                        def step_fn(p_, o_, c_, _r, *rest, step=step,
                                    cfg=cfg):
                            return step(p_, o_, c_, sd.init_comm_residuals(
                                cfg, WIN, group), *rest)
                    else:
                        step_fn = step
                    if how == "nudge":      # 2e-7 relative, from seed 99
                        gen = torch.Generator().manual_seed(99)
                        with torch.no_grad():
                            for leaf in params.parameters():
                                leaf.mul_(1 + 2e-7 * torch.randn(
                                    leaf.shape, generator=gen))
                    out[(seed, model, label)] = sd.train_distributed_streamed(
                        cfg, ds.snapshots, ds.values, ds.frames, ds.labels,
                        mesh=group, num_epochs=EPOCHS, params=params,
                        opt_cfg=_opt_cfg(), a2a_chunks=chunks,
                        compression=comp, step_fn=step_fn,
                        device="cpu").losses
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def print_int8_readings() -> None:
    """Print the largest loss gap of each port run on 4 gloo ranks from
    the JAX run of the same compression and chunks (and, for the nudged
    runs, from the port's own run without the nudge), over the data and
    parameter seeds 0-3.  Run: ``PYTHONPATH=src python
    tests/test_torch_dist_stream.py`` (about 3 minutes on 4 CPU cores)."""
    import tempfile

    import jax

    from repro.core import models as jm
    from repro.data import dyngnn as jdata
    from repro.launch.mesh import make_host_mesh
    from repro.stream import distributed as jsd
    mesh = make_host_mesh(data=P, model=1)
    jparams, jlosses = {}, {}
    for seed in READING_SEEDS:
        for model in ("tmgcn", "cdgcn"):
            cfg = jm.DynGNNConfig(model=model, num_nodes=N, num_steps=T,
                                  window=W, checkpoint_blocks=NB)
            params = jm.init_params(jax.random.PRNGKey(seed), cfg)
            jparams[(seed, model)] = jax.tree.map(np.asarray, params)
            ds = jdata.synthetic_dataset(N, T, density=2.0, churn=0.1,
                                         smoothing_mode=SMOOTH[model],
                                         window=W, seed=seed)
            for comp, chunks in {(c, k) for c, k, _ in
                                 READING_RUNS.values()}:
                jlosses[(seed, model, comp, chunks)] = np.asarray(
                    jsd.train_distributed_streamed(
                        cfg, ds.snapshots, ds.values, np.asarray(ds.frames),
                        np.asarray(ds.labels), mesh=mesh,
                        num_epochs=EPOCHS, params=params,
                        a2a_chunks=chunks, compression=comp).losses)
    with tempfile.TemporaryDirectory() as d:
        run_ranks(_readings_rank, P, (str(Path(d) / "store"),
                                      str(Path(d) / "out.pkl"), jparams),
                  600)
        with open(Path(d) / "out.pkl", "rb") as f:
            port = pickle.load(f)
    for model in ("tmgcn", "cdgcn"):
        for label, (comp, chunks, how) in READING_RUNS.items():
            gaps = []
            for seed in READING_SEEDS:
                got = np.asarray(port[(seed, model, label)])
                want = (np.asarray(port[(seed, model, label.split(",")[0])])
                        if how == "nudge"
                        else jlosses[(seed, model, comp, chunks)])
                gaps.append((np.abs(got - want).max(),
                             (np.abs(got - want) / np.abs(want)).max()))
            ref = "the port unnudged" if how == "nudge" else "JAX"
            print(f"{model:6} {label:27} vs {ref:18}: largest absolute "
                  f"{max(a for a, _ in gaps):.2e}, relative "
                  f"{max(r for _, r in gaps):.2e}  (per seed: "
                  + ", ".join(f"{a:.1e}" for a, _ in gaps) + ")")


if __name__ == "__main__":
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    print_int8_readings()
