"""Elastic rescale of the distributed stream (``repro_torch.elastic``) on 8
gloo ranks, held to the JAX package's ``repro.elastic``
(``tests/test_elastic.py:85-480``).

One pool of 8 rank processes per module (``pool``) runs every training
case on the CPU and writes each rank's results to ``tmp_path``; the tests
below read them and compare with the JAX serial single-device reference
(``train_streamed(slice_len=8)``, 2 epochs) computed here in the parent.
The ranks are started with the spawn method and import this module for
its rank program, so the module imports no JAX at its top: the JAX side is
the ``jx`` fixture's.  Sizes are the reference's (N = 48, T = 16, nb 2:
rounds of 8 snapshots, 2 an epoch).  Every run starts from the JAX
parameters (``PRNGKey(0)``).

* the scripted P = 4 -> 8 -> 2 with and without ``pipeline_rounds`` /
  ``a2a_chunks=2``: losses at rtol 1e-5, the events, widths, segments and
  payload bytes equal to ``comm_volume.rescale_payload`` on the JAX trees;
* the direct loop 2 -> 4; the preemption shrink; preempt -> checkpoint at
  P = 4 -> resume at P = 8; a checkpointed run equal to the plain one and
  resuming a complete run; refusing a re-blocked cursor; not replaying
  realized rescales; realizing an event at the cursor;
* a SIGTERM raised on rank 0 only: every rank stops after the same round
  and the checkpoint resumes to the uninterrupted loss stream;
* a checkpoint restored onto the group: every rank's rows of the full-N
  carries; the resolve-time width checks against the pool's 8 ranks;
* in the parent: the from-boundary encoding equal to the tail, the
  controller, plan, lcm-padding, ``validate_widths`` and payload-model
  checks, and the ``torchrun`` launcher rescaling 2 -> 1 on 2 ranks.
"""

import datetime
import os
import pickle
import signal
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

from repro_torch import convert
from repro_torch import elastic as el
from repro_torch.ckpt import Checkpointer
from repro_torch.core import models as tm
from repro_torch.data import dyngnn as data
from repro_torch.dist import comm_volume as cv
from repro_torch.ft.elastic import PreemptionGuard
from repro_torch.run import (CheckpointSpec, Engine, ExecutionPlan,
                             InMemoryDTDG, RunConfig)
from repro_torch.stream import sharded as stream_sharded

ROOT = Path(__file__).resolve().parents[1]
P = 8
N, T, NB, W = 48, 16, 2, 3
WIN = T // NB                      # 8 snapshots per round; rpe = 2
EPOCHS = 2
POOL_DEADLINE_S = 180


# ------------------------------------------------------- the rank program ---

def _silent(_msg):
    return None


def _trace():
    ds = data.synthetic_dataset(N, T, density=2.0, churn=0.1,
                                smoothing_mode="mproduct", window=W, seed=0)
    cfg = tm.DynGNNConfig(model="tmgcn", num_nodes=N, num_steps=T, window=W,
                          checkpoint_blocks=NB)
    return cfg, ds, data.DTDGPipeline(ds, nb=NB, device="cpu")


def _killer(when):
    """A log_fn that SIGTERMs this process at the first message for which
    ``when(msg, count)`` holds (``count``: messages seen so far)."""
    seen = []

    def log(msg):
        if "dist stream round" in msg:
            if when(msg, len(seen)) and not any(s is True for s in seen):
                seen.append(True)
                os.kill(os.getpid(), signal.SIGTERM)
            else:
                seen.append(False)

    return log


def _summary(res, rank_params=False) -> dict:
    rep = res.rescale_report
    out = {"losses": res.losses, "step": res.state.step,
           "per_shard_bytes": res.per_shard_bytes}
    if rep is not None:
        out["report"] = {
            "events": [(e.block, e.old_p, e.new_p, e.payload_bytes,
                        e.recompose_s, e.cause) for e in rep.events],
            "segments": rep.segments, "widths": rep.widths,
            "preempted": rep.preempted, "resumed_from": rep.resumed_from}
    if rank_params:
        out["params"] = convert.params_to_numpy(res.state.params)
    return out


def _cases(rank, groups, jparams, out_dir):
    cfg, ds, pipe = _trace()
    src = InMemoryDTDG(ds, pipeline=pipe)

    def engine(plan, **kw):
        kw.setdefault("log_fn", _silent)
        return Engine(RunConfig(model=cfg, data=src, plan=plan, **kw),
                      params=convert.params_from_jax(jparams),
                      device="cpu")

    def ckdir(name):
        return CheckpointSpec(str(Path(out_dir) / name), every=100)

    res = {}
    for pipelined in (False, True):
        res[f"scripted-{pipelined}"] = _summary(engine(ExecutionPlan(
            mode="streamed_mesh", shards=4, num_epochs=EPOCHS,
            rescale=((1, 8), (3, 2)), a2a_chunks=2 if pipelined else 1,
            pipeline_rounds=pipelined)).fit(), rank_params=True)

    st = el.train_elastic_streamed(
        cfg, ds.snapshots, ds.values, ds.frames, ds.labels,
        controller=el.RescaleController(initial_p=2, schedule=((2, 4),)),
        num_epochs=EPOCHS, params=convert.params_from_jax(jparams),
        device="cpu")
    res["direct"] = {"losses": st.losses, "completed": st.completed,
                     "cursor": st.cursor,
                     "events": [(e.old_p, e.new_p) for e in st.report.events]}

    res["shrink"] = _summary(engine(
        ExecutionPlan(mode="streamed_mesh", shards=4, num_epochs=EPOCHS,
                      rescale_on_preempt=2),
        log_fn=_killer(lambda m, c: True), log_every=1).fit())

    # fixed-width plans on 4 of the 8 ranks run on the width-4 group
    g4 = groups[4]
    on4 = dict(mode="streamed_mesh", mesh=g4, num_epochs=EPOCHS)
    if rank < 4:
        res["preempt-first"] = _summary(engine(
            ExecutionPlan(**on4), checkpoint=ckdir("p48"),
            log_fn=_killer(lambda m, c: True), log_every=1).fit())
    dist.barrier()
    res["preempt-resumed"] = _summary(engine(
        ExecutionPlan(mode="streamed_mesh", shards=8, num_epochs=EPOCHS),
        checkpoint=ckdir("p48")).resume())

    if rank < 4:
        plain = engine(ExecutionPlan(**on4)).fit()
        ck = engine(ExecutionPlan(**on4), checkpoint=CheckpointSpec(
            str(Path(out_dir) / "every1"), every=1)).fit()
        done = engine(ExecutionPlan(**on4), checkpoint=CheckpointSpec(
            str(Path(out_dir) / "every1"), every=1)).resume()
        res["ckpt"] = {"plain": _summary(plain), "ck": _summary(ck),
                       "done": _summary(done),
                       "latest": Checkpointer(
                           Path(out_dir) / "every1").latest_step()}
    dist.barrier()

    import dataclasses
    cfg4 = dataclasses.replace(cfg, checkpoint_blocks=4)   # win 4, rpe 4
    src4 = InMemoryDTDG(ds, pipeline=data.DTDGPipeline(ds, nb=4,
                                                       device="cpu"))
    if rank < 4:
        Engine(RunConfig(model=cfg4, data=src4,
                         plan=ExecutionPlan(mode="streamed_mesh", mesh=g4),
                         checkpoint=ckdir("reblock"),
                         log_fn=_killer(lambda m, c: True), log_every=1),
               device="cpu").fit()
    dist.barrier()
    try:
        Engine(RunConfig(model=cfg4, data=src4,
                         plan=ExecutionPlan(mode="streamed_mesh", shards=8),
                         checkpoint=ckdir("reblock"), log_fn=_silent),
               device="cpu").resume()
        res["reblock"] = None
    except ValueError as e:
        res["reblock"] = str(e)

    plan8 = ExecutionPlan(mode="streamed_mesh", shards=4, num_epochs=EPOCHS,
                          rescale=((1, 8),))
    res["replay-first"] = _summary(engine(
        plan8, checkpoint=ckdir("replay"),
        log_fn=_killer(lambda m, c: "P=8" in m), log_every=1).fit())
    res["replay-resumed"] = _summary(engine(
        plan8, checkpoint=ckdir("replay")).resume())

    plan_at = ExecutionPlan(mode="streamed_mesh", shards=4,
                            num_epochs=EPOCHS, rescale=((2, 8),))
    res["cursor-first"] = _summary(engine(
        plan_at, checkpoint=ckdir("cursor"),
        log_fn=_killer(lambda m, c: "P=4" in m and c == 1),
        log_every=1).fit())
    res["cursor-resumed"] = _summary(engine(
        plan_at, checkpoint=ckdir("cursor")).resume())

    # SIGTERM on rank 0 alone, mid-run, on an elastic plan whose later
    # width takes all 8 ranks: the other ranks never see a signal
    plan_one = ExecutionPlan(mode="streamed_mesh", shards=4,
                             num_epochs=EPOCHS, rescale=((3, 8),))
    log = (_killer(lambda m, c: c == 1) if rank == 0 else _silent)
    res["rank0-first"] = _summary(engine(
        plan_one, checkpoint=ckdir("rank0"), log_fn=log,
        log_every=1).fit(), rank_params=True)
    res["rank0-resumed"] = _summary(engine(
        plan_one, checkpoint=ckdir("rank0")).resume(), rank_params=True)

    # a checkpoint restored onto the group: rank 0 writes the full-N
    # carries, every rank restores them and keeps its N/8 rows
    full = [torch.arange((W - 1) * N * 6, dtype=torch.float32)
            .reshape(W - 1, N, 6) + 1000 * layer for layer in range(2)]
    ck = Checkpointer(Path(out_dir) / "onto")
    if rank == 0:
        ck.save(1, {"carries": full}, extra={"p": 1}, blocking=True)
    dist.barrier()
    like = {"carries": tm.init_carries(cfg, convert.params_from_jax(
        jparams))}
    tree, extra = ck.restore(1, like)
    res["onto"] = {"extra": extra, "rows": [
        c.numpy() for c in el.slice_carries(cfg, tree["carries"], P, rank)]}

    errs = {}
    for key, rescale in (("3", ((1, 3),)), ("512", ((1, 512),))):
        try:
            engine(ExecutionPlan(mode="streamed_mesh", shards=4,
                                 rescale=rescale)).resolve()
            errs[key] = None
        except ValueError as e:
            errs[key] = str(e)
    res["resolve"] = errs
    return res


def _rank_main(rank, store_path, out_dir, jparams):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, P),
                            rank=rank, world_size=P,
                            timeout=datetime.timedelta(seconds=60))
    try:
        # every width's group, made by every rank in one order
        groups = el.width_groups((2, 4, 8), dist.group.WORLD)
        res = _cases(rank, groups, jparams, out_dir)
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

    from repro import elastic as jel
    from repro.core import models as jm
    from repro.data import dyngnn as jdata
    from repro.optim import adamw as jadamw
    from repro.run import ExecutionPlan as JPlan
    from repro.stream import sharded as jsharded
    from repro.stream import train_loop as jtl
    return types.SimpleNamespace(**locals())


@pytest.fixture(scope="module")
def jparams(jx):
    cfg = jx.jm.DynGNNConfig(model="tmgcn", num_nodes=N, num_steps=T,
                             window=W, checkpoint_blocks=NB)
    return jx.jax.tree.map(np.asarray, jx.jm.init_params(
        jx.jax.random.PRNGKey(0), cfg))


@pytest.fixture(scope="module")
def serial_ref(jx):
    """The JAX single-device slice-granularity reference, 2 epochs."""
    ds = jx.jdata.synthetic_dataset(N, T, density=2.0, churn=0.1,
                                    smoothing_mode="mproduct", window=W,
                                    seed=0)
    cfg = jx.jm.DynGNNConfig(model="tmgcn", num_nodes=N, num_steps=T,
                             window=W, checkpoint_blocks=NB)
    return jx.jtl.train_streamed(
        cfg, ds.snapshots, ds.values, np.asarray(ds.frames),
        np.asarray(ds.labels), num_epochs=EPOCHS, overlap=False,
        slice_len=WIN).losses


@pytest.fixture(scope="module")
def pool(tmp_path_factory, jparams):
    """Every case on 8 gloo ranks -> [rank 0's results, ..., rank 7's]."""
    d = tmp_path_factory.mktemp("elastic")
    run_ranks(_rank_main, P, (str(d / "store"), str(d), jparams),
              POOL_DEADLINE_S)
    out = []
    for r in range(P):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _expected_bytes(jx):
    """The JAX trees' carry and state bytes (the report must match
    ``comm_volume.rescale_payload`` on exactly these)."""
    cfg = jx.jm.DynGNNConfig(model="tmgcn", num_nodes=N, num_steps=T,
                             window=W, checkpoint_blocks=NB)
    params = jx.jm.init_params(jx.jax.random.PRNGKey(0), cfg)
    carry_b = jx.jel.tree_bytes(jx.jm.init_carries(cfg, params))
    state_b = jx.jel.tree_bytes(params) + jx.jel.tree_bytes(
        jx.jadamw.init_state(params))
    return carry_b, state_b


def _every_rank_same(pool, key):
    first = pool[0][key]
    for r in pool[1:]:
        assert r[key]["losses"] == first["losses"]
        assert r[key]["step"] == first["step"]
    return first


# --------------------------------------------- acceptance: equivalence ------

@pytest.mark.parametrize("pipelined", [False, True])
def test_scripted_rescale_4_8_2_matches_serial_reference(pool, jx,
                                                         serial_ref,
                                                         pipelined):
    """P = 4 -> 8 -> 2 mid-run (boundaries at global rounds 1 and 3, both
    mid-epoch), with and without the pipelined rounds and chunked
    all-to-alls: the serial reference's losses at rtol 1e-5, the events,
    widths and segments of the reference, payload bytes by
    ``comm_volume.rescale_payload``, and one final state on all 8 ranks."""
    res = _every_rank_same(pool, f"scripted-{pipelined}")
    assert len(res["losses"]) == len(serial_ref) == EPOCHS * NB
    np.testing.assert_allclose(res["losses"], serial_ref, rtol=1e-5)
    rep = res["report"]
    assert [e[:3] for e in rep["events"]] == [(1, 4, 8), (3, 8, 2)]
    assert rep["widths"] == [4, 8, 2]
    carry_b, state_b = _expected_bytes(jx)
    assert rep["events"][0][3] == int(cv.rescale_payload(carry_b, state_b,
                                                         4, 8))
    assert rep["events"][1][3] == int(cv.rescale_payload(carry_b, state_b,
                                                         8, 2))
    assert all(e[4] >= 0 and e[5] == "scheduled" for e in rep["events"])
    assert [(s[0], s[1]) for s in rep["segments"]] == \
        [(0, 4), (1, 8), (2, 8), (3, 2)]
    for _start, p, per_shard in rep["segments"]:
        assert len(per_shard) == p and all(b > 0 for b in per_shard)
    for r in pool[1:]:
        got = r[f"scripted-{pipelined}"]
        assert got["report"]["segments"] == rep["segments"]
        for k, v in res["params"].items():
            np.testing.assert_array_equal(got["params"][k], v)


def test_direct_elastic_loop_matches_reference(pool, serial_ref):
    for r in pool:
        st = r["direct"]
        assert st["completed"] and st["cursor"] == 4
        np.testing.assert_allclose(st["losses"], serial_ref, rtol=1e-5)
        assert st["events"] == [(2, 4)]


def test_preemption_shrink_continues_at_lower_width(pool, serial_ref):
    res = _every_rank_same(pool, "shrink")
    np.testing.assert_allclose(res["losses"], serial_ref, rtol=1e-5)
    rep = res["report"]
    assert not rep["preempted"]                 # absorbed, not stopped
    assert len(rep["events"]) == 1
    block, old_p, new_p, _, _, cause = rep["events"][0]
    assert cause == "preemption" and new_p == 2 and old_p == 4


def test_preempt_checkpoint_resume_onto_larger_width(pool, serial_ref):
    """SIGTERM at P = 4 saves a checkpoint with the data cursor; resume on
    all 8 ranks (P = 8) continues it, and the two loss streams together
    are the uninterrupted run's."""
    first = pool[0]["preempt-first"]
    assert all(r["preempt-first"] == first for r in pool[1:4])
    assert first["report"]["preempted"]
    assert 0 < len(first["losses"]) < EPOCHS * NB
    assert first["step"] == len(first["losses"])
    resumed = _every_rank_same(pool, "preempt-resumed")
    assert resumed["report"]["resumed_from"] == first["step"]
    assert resumed["step"] == EPOCHS * NB
    np.testing.assert_allclose(first["losses"] + resumed["losses"],
                               serial_ref, rtol=1e-5)


def test_checkpointed_run_matches_plain_and_periodic_saves(pool):
    """A CheckpointSpec on a fixed-width plan is pure schedule: losses
    identical to the plain run, the per-rank byte accounting intact, a
    save at every round; resuming the complete run trains nothing."""
    for r in pool[:4]:
        c = r["ckpt"]
        assert "report" not in c["plain"]         # plain path untouched
        assert c["ck"]["losses"] == c["plain"]["losses"]
        assert c["ck"]["per_shard_bytes"] is not None
        assert sum(c["ck"]["per_shard_bytes"]) == \
            sum(c["plain"]["per_shard_bytes"])
        assert c["latest"] == EPOCHS * NB
        assert c["done"]["losses"] == [] and c["done"]["step"] == EPOCHS * NB


def test_resume_rejects_reblocked_cursor(pool):
    for r in pool:
        assert r["reblock"] is not None and "rounds per epoch" in r["reblock"]


def test_resume_does_not_replay_realized_rescales(pool, serial_ref):
    first = _every_rank_same(pool, "replay-first")
    assert first["report"]["preempted"]
    assert [(e[0], e[2]) for e in first["report"]["events"]] == [(1, 8)]
    assert first["step"] > 1
    resumed = _every_rank_same(pool, "replay-resumed")
    assert resumed["report"]["events"] == []
    np.testing.assert_allclose(first["losses"] + resumed["losses"],
                               serial_ref, rtol=1e-5)


def test_resume_realizes_event_scheduled_at_the_cursor(pool, serial_ref):
    first = _every_rank_same(pool, "cursor-first")
    assert first["report"]["preempted"]
    assert first["step"] == 2                     # cursor == boundary
    assert first["report"]["events"] == []        # not realized yet
    assert first["per_shard_bytes"] is None
    resumed = _every_rank_same(pool, "cursor-resumed")
    assert [e[:3] for e in resumed["report"]["events"]] == [(2, 4, 8)]
    np.testing.assert_allclose(first["losses"] + resumed["losses"],
                               serial_ref, rtol=1e-5)


def test_sigterm_on_rank_0_alone_stops_every_rank_at_one_round(pool,
                                                               serial_ref):
    """Only rank 0's process gets the SIGTERM (during round 1): the ranks
    agree on it, so all 8 — the 4 training and the 4 waiting for the
    width-8 segment — stop with the same cursor, losses and parameters,
    and the checkpoint resumes to the uninterrupted loss stream."""
    first = _every_rank_same(pool, "rank0-first")
    assert first["report"]["preempted"] and first["step"] == 2
    assert first["report"]["events"] == []
    for r in pool[1:]:
        assert r["rank0-first"]["report"]["preempted"]
        for k, v in first["params"].items():
            np.testing.assert_array_equal(r["rank0-first"]["params"][k], v)
    resumed = _every_rank_same(pool, "rank0-resumed")
    assert resumed["report"]["resumed_from"] == 2
    assert [e[:3] for e in resumed["report"]["events"]] == [(3, 4, 8)]
    np.testing.assert_allclose(first["losses"] + resumed["losses"],
                               serial_ref, rtol=1e-5)
    for r in pool[1:]:
        for k, v in resumed["params"].items():
            np.testing.assert_array_equal(r["rank0-resumed"]["params"][k], v)


def test_checkpoint_restores_onto_the_group(pool):
    """Rank 0's full-N checkpoint restored on every rank of the group,
    each keeping its N/8 vertex rows of every carry."""
    full = [np.arange((W - 1) * N * 6, dtype=np.float32)
            .reshape(W - 1, N, 6) + 1000 * layer for layer in range(2)]
    n_loc = N // P
    for rank, r in enumerate(pool):
        assert r["onto"]["extra"] == {"p": 1}
        for got, want in zip(r["onto"]["rows"], full, strict=True):
            np.testing.assert_array_equal(
                got, want[:, rank * n_loc:(rank + 1) * n_loc])


def test_resolve_rejects_unrealizable_widths(pool):
    for r in pool:
        assert "does not divide the checkpoint" in r["resolve"]["3"]
        assert "exceeds the 8 attached devices" in r["resolve"]["512"]


# ----------------------------------------------- stream recompose ----------

def test_encode_time_sliced_from_boundary_equals_tail(jx):
    """Re-slicing the remaining trace from a block boundary gives exactly
    the tail of the from-zero encoding (what ``ElasticRuntime`` slices),
    and both equal the JAX package's, field for field."""
    _, ds, pipe = _trace()
    p = 4
    stats = pipe.stream_stats
    full = stream_sharded.encode_time_sliced(
        ds.snapshots, ds.values, N, pipe.max_edges, WIN, p, stats)
    tail = stream_sharded.encode_time_sliced(
        ds.snapshots, ds.values, N, pipe.max_edges, WIN, p, stats,
        start_step=WIN)
    jds = jx.jdata.synthetic_dataset(N, T, density=2.0, churn=0.1,
                                     smoothing_mode="mproduct", window=W,
                                     seed=0)
    jpipe = jx.jdata.DTDGPipeline(jds, nb=NB)
    jtail = jx.jsharded.encode_time_sliced(
        jds.snapshots, jds.values, N, jpipe.max_edges, WIN, p,
        jpipe.stream_stats, start_step=WIN)
    bsl = WIN // p
    for s in range(p):
        want = full[s][bsl:]
        got = tail[s]
        assert len(got) == len(want) == len(jtail[s])
        assert type(got[0]).__name__ == "FullSnapshot"
        for a, b, c in zip(got, want, jtail[s]):
            assert type(a) is type(b)
            assert type(a).__name__ == type(c).__name__
            assert a.payload_bytes == b.payload_bytes == c.payload_bytes
            for fld in ("edges", "mask", "values", "drop_pos", "drop_mask",
                        "add_edges", "add_mask"):
                if hasattr(a, fld):
                    np.testing.assert_array_equal(np.asarray(getattr(a, fld)),
                                                  np.asarray(getattr(b, fld)))
                    np.testing.assert_array_equal(np.asarray(getattr(a, fld)),
                                                  np.asarray(getattr(c, fld)))
    with pytest.raises(ValueError, match="block boundary"):
        stream_sharded.encode_time_sliced(
            ds.snapshots, ds.values, N, pipe.max_edges, WIN, p, stats,
            start_step=3)


# ---------------------------------------------- policy / validation --------

def test_controller_schedule_and_preemption_logic(jx):
    ctrl = el.RescaleController(initial_p=4, schedule=((1, 8), (3, 2)))
    jctrl = jx.jel.RescaleController(initial_p=4, schedule=((1, 8), (3, 2)))
    for b in range(6):
        assert ctrl.scripted_width(b) == jctrl.scripted_width(b)
        assert ctrl.next_boundary(b) == jctrl.next_boundary(b)
    assert ctrl.scripted_width(0) == 4 and ctrl.scripted_width(5) == 2
    assert ctrl.next_boundary(1) == 3 and ctrl.next_boundary(3) is None
    assert ctrl.widths == jctrl.widths == (4, 8, 2)
    assert not ctrl.interrupt() and not ctrl.should_stop()

    with PreemptionGuard() as g:
        shrink = el.RescaleController(initial_p=4, guard=g, shrink_to=2)
        stop = el.RescaleController(initial_p=4, guard=g)
        os.kill(os.getpid(), signal.SIGTERM)
        assert shrink.interrupt() and not shrink.should_stop()
        assert stop.interrupt() and stop.should_stop()
        assert shrink.width_at(2, 4) == (2, "preemption")
        assert not shrink.interrupt()
        assert shrink.width_at(3, 2) == (2, "preemption")
        os.kill(os.getpid(), signal.SIGTERM)
        assert shrink.interrupt() and shrink.should_stop()

    with PreemptionGuard() as g2:
        noop = el.RescaleController(initial_p=4, guard=g2, shrink_to=4)
        os.kill(os.getpid(), signal.SIGTERM)
        assert noop.should_stop(4)
        assert noop.width_at(1, 4) == (4, "scheduled")   # no absorb
        assert noop.interrupt()                          # flag kept


@pytest.mark.parametrize("schedule,match", [
    (((2, 8), (2, 2)), "strictly increasing"), (((0, 8),), "block 1"),
    (((1, 0),), "width must be >= 1"), ((8,), "pairs")])
def test_controller_rejects_bad_schedules(jx, schedule, match):
    for ctrl in (el.RescaleController, jx.jel.RescaleController):
        with pytest.raises(ValueError, match=match):
            ctrl(4, schedule=schedule)


def test_plan_rescale_validation(jx):
    for plan_cls in (ExecutionPlan, jx.JPlan):
        with pytest.raises(ValueError, match="streamed_mesh"):
            plan_cls(mode="eager", rescale=((1, 2),)).validate()
        with pytest.raises(ValueError, match="streamed_mesh"):
            plan_cls(mode="streamed", rescale_on_preempt=2).validate()
        with pytest.raises(ValueError, match="strictly increasing"):
            plan_cls(mode="streamed_mesh", shards=2,
                     rescale=((2, 4), (1, 2))).validate()
        with pytest.raises(ValueError, match="block 0"):
            plan_cls(mode="streamed_mesh", shards=2,
                     rescale=((0, 4),)).validate()
        with pytest.raises(ValueError, match="pairs"):
            plan_cls(mode="streamed_mesh", shards=2, rescale=(4,)).validate()
        with pytest.raises(ValueError, match="elastic"):
            plan_cls(mode="streamed_mesh", shards=2, rescale=((1, 4),),
                     compression="int8_a2a").validate()
        plan_cls(mode="streamed_mesh", shards=2, rescale=((1, 4),),
                 rescale_on_preempt=1).validate()
        plan = plan_cls(mode="streamed_mesh", shards=2,
                        rescale=((1, 4), (2, 8)), rescale_on_preempt=1)
        assert plan.rescale_widths == (4, 8, 1)
        assert plan.is_elastic
        assert not plan_cls(mode="streamed_mesh", shards=2).is_elastic


def test_plan_pads_vertex_axis_to_lcm_of_widths(jx):
    for plan_cls in (ExecutionPlan, jx.JPlan):
        plan = plan_cls(mode="streamed_mesh", shards=2, rescale=((1, 8),))
        assert plan.padded_num_nodes(50) == 56          # lcm(2, 8) = 8
        assert plan.padded_num_nodes(48) == 48
        fixed = plan_cls(mode="streamed_mesh", shards=2)
        assert fixed.padded_num_nodes(50) == 50


def test_validate_widths_direct(jx):
    for fn in (el.validate_widths, jx.jel.validate_widths):
        fn({1, 2, 4}, win=8, num_nodes=N, num_devices=8)
        with pytest.raises(ValueError, match="does not divide the "
                                             "checkpoint"):
            fn({3}, win=8, num_nodes=N, num_devices=8)
        with pytest.raises(ValueError, match="exceeds"):
            fn({16}, win=16, num_nodes=N, num_devices=8)
        with pytest.raises(ValueError, match="num_nodes"):
            fn({5}, win=5, num_nodes=N, num_devices=8)


def test_rescale_payload_model_and_tree_bytes(jx):
    assert cv.rescale_payload(100.0, 10.0, 4, 4) == 0.0
    assert cv.rescale_payload(100.0, 10.0, 4, 8) == 100.0 + 4 * 10.0
    assert cv.rescale_payload(100.0, 10.0, 8, 2) == 100.0
    with pytest.raises(ValueError, match=">= 1"):
        cv.rescale_payload(1.0, 1.0, 0, 4)
    cfg, _, _ = _trace()
    jcfg = jx.jm.DynGNNConfig(model="tmgcn", num_nodes=N, num_steps=T,
                              window=W, checkpoint_blocks=NB)
    jp = jx.jm.init_params(jx.jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(jx.jax.tree.map(np.asarray, jp))
    from repro_torch.optim import adamw
    carries = tm.init_carries(cfg, params)
    opt = adamw.init_state(params)
    for old, new in ((4, 8), (8, 2), (2, 2)):
        assert el.rescale_payload_bytes(params, opt, carries, old, new) == \
            jx.jel.rescale_payload_bytes(jp, jx.jadamw.init_state(jp),
                                         jx.jm.init_carries(jcfg, jp),
                                         old, new)
    assert el.tree_bytes(None) == 0


# ------------------------------------------------------------ launcher -----

def test_torchrun_launcher_rescales_on_two_ranks(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train --stream
    --mesh 2 --rescale-at 1:1 --epochs 2 --ckpt-dir D``: rank 0 prints
    the elastic summary line.  No checkpoint falls due in 4 rounds
    (``CheckpointSpec.every`` is 50), so a relaunch trains the same run
    again and prints the same line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
           "--arch", "paper_dyngnn", "--stream", "--mesh", "2",
           "--rescale-at", "1:1", "--epochs", "2", "--ckpt-dir",
           str(tmp_path / "ck"), "--device", "cpu"]
    lines = []
    for _ in range(2):
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=120, env=env, cwd=ROOT)
        assert out.returncode == 0, out.stderr[-4000:]
        done = [ln for ln in out.stdout.splitlines()
                if ln.startswith("streamed ")]
        assert len(done) == 1, out.stdout
        lines.append(done[0])
    assert lines[0].startswith("streamed 4 block rounds elastically "
                               "(completed), final loss ")
    assert "rescales: 2->1@block1 (scheduled, " in lines[0]
    assert lines[1] == lines[0]
    assert Checkpointer(tmp_path / "ck").all_steps() == []
