"""Fault tolerance of the port held to the JAX package: checkpoints
(``repro_torch.ckpt``), preemption and re-meshing (``ft.elastic``), the
straggler watchdog (``ft.straggler``) and the Engine's eager resume.

Sizes are ``tests/test_ft.py``'s and ``tests/test_run_api.py``'s (N = 48,
T = 16, window 3, nb 2).  In one process:

* the checkpoint round trip, async retention and the structure-mismatch
  refusal (``tests/test_ft.py:25-50``); the port's ``(params,
  opt_state)`` flattens to the JAX eager trainer's paths in its order;
* a checkpoint written by the JAX ``Engine`` (eager, 5 steps) resumed by
  the port's ``Engine`` gives the JAX run's remaining losses at rtol
  1e-5, and the port's own eager resume equals its uninterrupted run;
* ``remesh_plan``, the ``PreemptionGuard`` cases, the ``StepTimer`` cases
  (``straggler.flags``), the timer wired through
  ``train_distributed_streamed`` (a one-rank gloo group) and
  ``BackupShardSchedule``, each against the reference's copy;
* ``tests/test_run_api.py:351`` and ``:375``: the checkpoint refusal on
  streamed plans and the ``Engine.resume`` round trip, against the JAX
  Engine's losses.

The restore onto a group of ranks is ``tests/test_torch_elastic.py``'s.
"""

import os
import signal

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import obs as jobs
from repro.ckpt.checkpoint import Checkpointer as JCheckpointer
from repro.core import models as jm
from repro.ft import elastic as jelastic
from repro.ft import straggler as jstraggler
from repro.optim import adamw as jadamw
from repro.run import CheckpointSpec as JCheckpointSpec
from repro.run import Engine as JEngine
from repro.run import ExecutionPlan as JPlan
from repro.run import RunConfig as JRunConfig
from repro.run import SyntheticTrace as JTrace
from repro_torch import convert, obs
from repro_torch.ckpt import Checkpointer, flatten_with_paths
from repro_torch.core import models as tm
from repro_torch.data import dyngnn as data
from repro_torch.ft import elastic, straggler
from repro_torch.optim import adamw
from repro_torch.run import (CheckpointSpec, Engine, ExecutionPlan,
                             RunConfig, SamplingSpec, SyntheticTrace)
from repro_torch.stream import distributed as sd

N, T, W, NB = 48, 16, 3, 2
SMOOTH = {"tmgcn": "mproduct", "evolvegcn": "edgelife", "cdgcn": "none"}


def _silent(_msg):
    return None


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "nested": {"b": torch.arange(6, dtype=torch.float32),
                       "c": [torch.ones((2,)), torch.zeros((3,))]}}


def _cfg(model="tmgcn"):
    return tm.DynGNNConfig(model=model, num_nodes=N, num_steps=T, window=W,
                           checkpoint_blocks=NB)


def _jcfg(model="tmgcn"):
    return jm.DynGNNConfig(model=model, num_nodes=N, num_steps=T, window=W,
                           checkpoint_blocks=NB)


def _src(cls, model="tmgcn"):
    return cls(num_nodes=N, num_steps=T, density=2.0, churn=0.1,
               smoothing_mode=SMOOTH[model], window=W)


def _engine(model, plan, **kw):
    kw.setdefault("log_fn", _silent)
    return Engine(RunConfig(model=_cfg(model), data=_src(SyntheticTrace,
                                                         model),
                            plan=plan, **kw), device="cpu")


def _jengine(model, plan, **kw):
    kw.setdefault("log_fn", _silent)
    return JEngine(JRunConfig(model=_jcfg(model), data=_src(JTrace, model),
                              plan=plan, **kw))


# ------------------------------------------------------------ checkpoints --

def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path)
    tree = _tree()
    ck.save(10, tree, extra={"cursor": 123}, blocking=True)
    restored, extra = ck.restore(10, tree)
    assert extra["cursor"] == 123
    assert isinstance(restored["nested"]["c"], list)
    for a, b in zip(flatten_with_paths(tree)[1],
                    flatten_with_paths(restored)[1], strict=True):
        assert torch.equal(a, b)


def test_checkpoint_async_and_retention(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    tree = _tree()
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
    ck.wait()
    assert ck.all_steps() == [3, 4]


def test_checkpoint_save_copies_before_returning(tmp_path):
    """An in-place update after ``save`` returns cannot reach the file
    the writer thread is still writing."""
    ck = Checkpointer(tmp_path)
    tree = _tree()
    want = tree["a"].clone()
    ck.save(1, tree)
    tree["a"].add_(1.0)
    ck.wait()
    got, _ = ck.restore(1, tree)
    assert torch.equal(got["a"], want)


def test_checkpoint_structure_mismatch_detected(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, _tree(), blocking=True)
    with pytest.raises(ValueError, match="incompatible"):
        ck.restore(1, {"a": torch.zeros((4, 8))})
    bad = _tree()
    bad["nested"]["d"] = bad["nested"].pop("b")     # same count, new path
    with pytest.raises(ValueError, match="incompatible"):
        ck.restore(1, bad)


@pytest.mark.parametrize("model", ["tmgcn", "cdgcn", "evolvegcn"])
def test_eager_state_flattens_to_the_jax_paths_and_order(model):
    """The port's ``(params, AdamW state)`` has the JAX eager trainer's
    leaf paths in ``jax.tree.leaves`` order, leaf for leaf."""
    jp = jm.init_params(jax.random.PRNGKey(0), _jcfg(model))
    jtree = (jp, jadamw.init_state(jp))
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    params = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    paths, leaves = flatten_with_paths((params, adamw.init_state(params)))
    assert paths == jpaths
    for a, b in zip(leaves, jax.tree.leaves(jtree), strict=True):
        assert tuple(a.shape) == b.shape


def test_opt_state_from_jax_matches_the_ports_layout():
    jp = jm.init_params(jax.random.PRNGKey(0), _jcfg("cdgcn"))
    jst = jax.tree.map(np.asarray, jadamw.init_state(jp))
    jst["step"] = np.asarray(7, np.int32)
    got = convert.opt_state_from_jax(jst)
    want = adamw.init_state(convert.params_from_jax(
        jax.tree.map(np.asarray, jp)))
    assert list(got) == list(want)
    for key in ("m", "v", "master"):
        assert list(got[key]) == list(want[key])
        for k in want[key]:
            assert torch.equal(got[key][k], want[key][k])
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7


def test_jax_written_eager_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX Engine trains 5 steps and checkpoints; the port's Engine
    resumes from that checkpoint to step 10 and gives the uninterrupted
    JAX run's losses of steps 5-9 at rtol 1e-5."""
    d = str(tmp_path / "ck")
    full = _jengine("tmgcn", JPlan(mode="eager", num_steps=10)).fit()
    _jengine("tmgcn", JPlan(mode="eager", num_steps=5),
             checkpoint=JCheckpointSpec(d, every=5)).fit()
    assert JCheckpointer(d).all_steps() == [5]
    res = _engine("tmgcn", ExecutionPlan(mode="eager", num_steps=10),
                  checkpoint=CheckpointSpec(d, every=5)).resume()
    assert res.state.step == 10 and len(res.losses) == 5
    np.testing.assert_allclose(res.losses, full.losses[5:], rtol=1e-5)
    want = {k: np.asarray(v) for k, v in
            zip(flatten_with_paths(convert.params_from_jax(
                jax.tree.map(np.asarray, full.state.params)))[0],
                jax.tree.leaves(full.state.params))}
    got = dict(zip(*flatten_with_paths(res.state.params)))
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v, atol=1e-6)


@pytest.mark.parametrize("model", ["tmgcn", "evolvegcn"])
def test_eager_resume_equals_the_uninterrupted_run(tmp_path, model):
    d = str(tmp_path / model)
    full = _engine(model, ExecutionPlan(mode="eager", num_steps=10)).fit()
    first = _engine(model, ExecutionPlan(mode="eager", num_steps=5),
                    checkpoint=CheckpointSpec(d, every=5)).fit()
    rest = _engine(model, ExecutionPlan(mode="eager", num_steps=10),
                   checkpoint=CheckpointSpec(d, every=5)).resume()
    assert first.losses + rest.losses == full.losses
    for a, b in zip(rest.state.params.parameters(),
                    full.state.params.parameters(), strict=True):
        assert torch.equal(a, b)


def test_eager_sigterm_saves_and_stops(tmp_path):
    """A SIGTERM during the eager fit checkpoints, blocking, and stops
    cleanly; resume completes the uninterrupted loss stream."""
    d = str(tmp_path / "ck")
    full = _engine("cdgcn", ExecutionPlan(mode="eager", num_steps=8)).fit()

    def killer(msg):
        if msg.startswith("step 2 "):
            os.kill(os.getpid(), signal.SIGTERM)

    first = _engine("cdgcn", ExecutionPlan(mode="eager", num_steps=8),
                    checkpoint=CheckpointSpec(d, every=100), log_fn=killer,
                    log_every=1).fit()
    assert first.state.step == 3 and Checkpointer(d).all_steps() == [3]
    rest = _engine("cdgcn", ExecutionPlan(mode="eager", num_steps=8),
                   checkpoint=CheckpointSpec(d, every=100)).resume()
    assert first.losses + rest.losses == full.losses


# ---------------------------------------------------------------- re-mesh --

@pytest.mark.parametrize("chips,mp", [(512, 16), (256, 16), (248, 16),
                                      (7, 4), (1, 16), (96, 8)])
def test_remesh_plan_is_the_reference(chips, mp):
    got = elastic.remesh_plan(chips, mp)
    want = jelastic.remesh_plan(chips, mp)
    assert (got.data, got.model) == (want.data, want.model)
    assert got.chips == chips
    assert elastic.remesh_plan(512, 16) == elastic.MeshPlan(32, 16)


# ------------------------------------------------------------- preemption --

def test_preemption_guard():
    with elastic.PreemptionGuard() as g:
        assert not g.preempted
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.preempted   # handler flips the flag instead of killing us


def test_preemption_guard_chains_previous_handler():
    calls = []

    def prev(signum, frame):
        calls.append(signum)

    before = signal.signal(signal.SIGTERM, prev)
    try:
        with elastic.PreemptionGuard() as g:
            os.kill(os.getpid(), signal.SIGTERM)
            assert g.preempted
            assert calls == [signal.SIGTERM]      # chained through
        assert signal.getsignal(signal.SIGTERM) is prev
    finally:
        signal.signal(signal.SIGTERM, before)


def test_preemption_guard_nested_guards_restore_in_order():
    base = signal.getsignal(signal.SIGTERM)
    with elastic.PreemptionGuard() as outer:
        mid = signal.getsignal(signal.SIGTERM)
        with elastic.PreemptionGuard() as inner:
            os.kill(os.getpid(), signal.SIGTERM)
            assert inner.preempted and outer.preempted
        assert signal.getsignal(signal.SIGTERM) is mid
    assert signal.getsignal(signal.SIGTERM) is base


def test_preemption_guard_sigint_opt_in():
    default_int = signal.getsignal(signal.SIGINT)
    with elastic.PreemptionGuard(catch_sigint=True) as g:
        os.kill(os.getpid(), signal.SIGINT)   # would raise if unhandled
        assert g.preempted
    assert signal.getsignal(signal.SIGINT) is default_int
    with elastic.PreemptionGuard() as g2:
        assert signal.getsignal(signal.SIGINT) is default_int
        assert not g2.preempted


# -------------------------------------------------------------- straggler --

def _both(**kw):
    return straggler.StepTimer(**kw), jstraggler.StepTimer(**kw)


def _same(t, jt):
    assert (t.mean, t.var, t.step_idx) == (jt.mean, jt.var, jt.step_idx)
    assert list(t.times) == list(jt.times)
    assert t.flagged_steps == jt.flagged_steps


def test_straggler_timer_flags_outliers():
    t, jt = _both(window=50, threshold_std=3.0)
    for _ in range(30):
        dt = 0.1 + np.random.default_rng(0).normal() * 1e-4
        assert t.observe(dt) == jt.observe(dt)
    assert t.observe(1.0) is True and jt.observe(1.0) is True
    assert t.straggler_rate > 0
    _same(t, jt)


def test_straggler_timer_ewma_recurrence():
    t, jt = _both(window=9, threshold_std=3.0, min_steps=3)
    assert t.alpha == pytest.approx(2.0 / 10.0)
    seq = [0.10, 0.12, 0.08, 0.11, 0.30, 0.10]
    mean, var = seq[0], 0.0
    t.observe(seq[0])
    jt.observe(seq[0])
    for dt in seq[1:]:
        t.observe(dt)
        jt.observe(dt)
        diff = dt - mean
        mean += t.alpha * diff
        var = (1 - t.alpha) * (var + t.alpha * diff * diff)
    assert t.mean == pytest.approx(mean)
    assert t.var == pytest.approx(var)
    assert t.step_idx == len(seq) and list(t.times) == seq
    _same(t, jt)


def test_straggler_timer_outlier_cannot_mask_itself():
    t, jt = _both(window=50, threshold_std=3.0, min_steps=5)
    for _ in range(20):
        t.observe(0.1)
        jt.observe(0.1)
    assert t.observe(5.0) is True and jt.observe(5.0) is True
    assert t.flagged_steps == [21]
    _same(t, jt)


def test_straggler_timer_reset():
    t = straggler.StepTimer(window=10, min_steps=2)
    for _ in range(8):
        t.observe(0.2)
    t.observe(9.0)
    t.reset()
    assert t.mean == 0.0 and t.var == 0.0 and t.step_idx == 0
    assert not t.times and not t.flagged_steps
    assert t.observe(9.0) is False
    assert t.mean == pytest.approx(9.0)


def test_straggler_timer_counts_flags_in_obs():
    before, jbefore = obs.metrics_snapshot(), jobs.metrics_snapshot()
    t, jt = _both(window=50, threshold_std=3.0, min_steps=5)
    for timer in (t, jt):
        for _ in range(20):
            timer.observe(0.1)
        timer.observe(5.0)
    assert obs.metrics().delta(before)["counters"]["straggler.flags"] == 1
    assert jobs.metrics().delta(jbefore)["counters"]["straggler.flags"] == 1


def test_straggler_timer_times_a_block():
    t = straggler.StepTimer()
    with t:
        sum(range(1000))
    assert t.step_idx == 1 and t.times[0] >= 0.0


def test_step_timer_wired_through_distributed_stream():
    """An injected StepTimer observes every distributed round (one-rank
    gloo group here; the pools of tests/test_torch_elastic.py share one
    across segments)."""
    ds = data.synthetic_dataset(N, T, density=2.0, churn=0.1,
                                smoothing_mode="mproduct", window=W, seed=0)
    timer = straggler.StepTimer(window=8)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        st = sd.train_distributed_streamed(
            _cfg(), ds.snapshots, ds.values, ds.frames, ds.labels,
            mesh=dist.group.WORLD, num_epochs=2, step_timer=timer,
            device="cpu")
        default = sd.train_distributed_streamed(
            _cfg(), ds.snapshots, ds.values, ds.frames, ds.labels,
            mesh=dist.group.WORLD, num_epochs=1, device="cpu")
    finally:
        dist.destroy_process_group()
    assert st.step_timer is timer
    assert timer.step_idx == len(st.losses) == 2 * NB
    assert len(timer.times) == 2 * NB
    assert isinstance(default.step_timer, straggler.StepTimer)
    assert default.step_timer.step_idx == NB


def test_backup_shard_schedule():
    sched = straggler.BackupShardSchedule(num_workers=8, num_backups=2)
    jsched = jstraggler.BackupShardSchedule(num_workers=8, num_backups=2)
    times = [0.1] * 8
    times[3], times[5] = 0.9, 0.8
    plan = sched.plan(times)
    assert plan == jsched.plan(times)
    assert set(plan.keys()) == {3, 5}
    assert sched.shard_for(3, 4) == jsched.shard_for(3, 4) == (12, 4)


# --------------------------------------------- tests/test_run_api.py:351 ---

def test_checkpoint_rejected_on_streamed_plans():
    """No silent checkpoint drops: a CheckpointSpec on a streamed or
    sampled plan, or with a compressed wire, fails loudly at resolve."""
    for plan in (ExecutionPlan(mode="streamed"),
                 ExecutionPlan(mode="sampled",
                               sampling=SamplingSpec(batch_nodes=8))):
        eng = _engine("tmgcn", plan,
                      checkpoint=CheckpointSpec("/tmp/never-used"))
        with pytest.raises(ValueError, match="only wired for plan.mode"):
            eng.resolve()
    eng = _engine("tmgcn", ExecutionPlan(mode="streamed_mesh",
                                         compression="int8_a2a"),
                  checkpoint=CheckpointSpec("/tmp/never-used"))
    with pytest.raises(ValueError, match="error-feedback"):
        eng.resolve()


def test_engine_resume_roundtrip(tmp_path):
    """``tests/test_run_api.py:375`` in the port, against the JAX Engine:
    10 steps with a checkpoint every 5, resumed to 15 (steps 10-14 run
    again, and their losses are the JAX Engine's from the same start)."""
    ck = CheckpointSpec(str(tmp_path / "ck"), every=5)
    jck = JCheckpointSpec(str(tmp_path / "jck"), every=5)
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0),
                                                 _jcfg("cdgcn")))
    cfg = RunConfig(model=_cfg("cdgcn"), data=_src(SyntheticTrace, "cdgcn"),
                    plan=ExecutionPlan(mode="eager", num_steps=10),
                    checkpoint=ck, log_fn=_silent)
    first = Engine(cfg, params=convert.params_from_jax(jp),
                   device="cpu").fit()
    assert first.state.step == 10
    eng2 = _engine("cdgcn", ExecutionPlan(mode="eager", num_steps=15),
                   checkpoint=ck)
    res = eng2.resume()
    assert res.state.step == 15
    assert len(res.losses) == 5               # only steps 10..14 re-run
    jfirst = _jengine("cdgcn", JPlan(mode="eager", num_steps=10),
                      checkpoint=jck).fit()
    jres = _jengine("cdgcn", JPlan(mode="eager", num_steps=15),
                    checkpoint=jck).resume()
    np.testing.assert_allclose(first.losses, jfirst.losses, rtol=1e-5)
    np.testing.assert_allclose(res.losses, jres.losses, rtol=1e-5)

    with pytest.raises(ValueError, match="RunConfig.checkpoint"):
        _engine("cdgcn", ExecutionPlan(mode="eager", num_steps=5)).resume()
    with pytest.raises(FileNotFoundError):
        _engine("cdgcn", ExecutionPlan(mode="eager", num_steps=5),
                checkpoint=CheckpointSpec(str(tmp_path / "empty"))
                ).resume()
