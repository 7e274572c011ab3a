"""The port's streamed schedule held to the JAX package.

Sizes are ``tests/test_stream.py``'s: ``synthetic_dataset(48, 8, density
2.0, churn 0.1)``, window 3, nb 2, two epochs.  Parameters cross over with
``convert.params_from_jax``.  On the CPU the kernel wrappers run their
plain versions and the prefetch worker stages through ``stage_item`` on
the host, so:

* ``train_streamed`` gives the JAX ``train_streamed`` loss stream at rtol
  1e-5 (``tests/test_dist_stream.py``'s tolerance) for TM-GCN, CD-GCN and
  EvolveGCN, per snapshot and with ``slice_len = 2``, its final
  parameters within 1e-4 (the eager Engine test's limit), and the first
  step's gradients equal ``jax.grad`` of the reference step's loss at 1e-5;
* ``overlap=True`` and ``overlap=False`` are bit-identical;
* ``Engine(mode="streamed")`` equals ``train_streamed`` called with the
  pipeline's arguments bit for bit, and the JAX Engine's streamed fit at
  rtol 1e-5;
* ``PrefetchIterator`` and ``SlotStacker`` behave as the reference's
  (``tests/test_stream.py``): order, errors, close, copies out of the ring;
* no gradient crosses a step (detached carries; EvolveGCN's ``w0``
  unchanged), and a step's launches and CSR builds are counted on the
  plain versions the card's wrappers reach.
"""

import functools
import itertools
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import models as jm
from repro.data import dyngnn as jdata
from repro.run import Engine as JEngine
from repro.run import ExecutionPlan as JPlan
from repro.run import RunConfig as JRunConfig
from repro.run import SyntheticTrace as JTrace
from repro.stream import train_loop as jst
from repro_torch import convert, obs
from repro_torch.core import graphdiff as gd
from repro_torch.core import models as tm
from repro_torch.data import dyngnn as data
from repro_torch.graph import generate
from repro_torch.kernels.mproduct import ops as mp_ops
from repro_torch.kernels.segment_spmm import ops as spmm_ops
from repro_torch.launch import train as launch_train
from repro_torch.optim import adamw
from repro_torch.run import (Engine, ExecutionPlan, InMemoryDTDG, RunConfig,
                             SyntheticTrace)
from repro_torch.stream import encoder as enc
from repro_torch.stream import train_loop as st
from repro_torch.stream.prefetch import (DeltaApplier, PrefetchIterator,
                                         SideStream, SlotStacker, stage_item)

N, T, W, NB, EPOCHS = 48, 8, 3, 2, 2
MODELS = ["tmgcn", "cdgcn", "evolvegcn"]
SMOOTH = {"tmgcn": "mproduct", "evolvegcn": "edgelife", "cdgcn": "none"}
RTOL = 1e-5


def _silent(_msg):
    return None


def _jcfg(model):
    return jm.DynGNNConfig(model=model, num_nodes=N, num_steps=T, window=W,
                           checkpoint_blocks=NB)


def _tcfg(model):
    return tm.DynGNNConfig(model=model, num_nodes=N, num_steps=T, window=W,
                           checkpoint_blocks=NB)


def _ds(model, seed=0):
    return data.synthetic_dataset(N, T, density=2.0, churn=0.1,
                                  smoothing_mode=SMOOTH[model], window=W,
                                  seed=seed)


def _jparams(model, seed=1):
    return jm.init_params(jax.random.PRNGKey(seed), _jcfg(model))


def _tparams(jparams):
    return convert.params_from_jax(jax.tree.map(np.asarray, jparams))


def _named(tree) -> dict:
    """A JAX tree -> {``layers.0.gcn.w``: numpy}, the port's names."""
    return {jax.tree_util.keystr(k, simple=True, separator="."):
            np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_named(params) -> dict:
    return {k: v.detach().numpy() for k, v in params.named_parameters()}


@functools.lru_cache(maxsize=None)
def _jax_stream(model, slice_len):
    """The JAX ``train_streamed`` over the shared trace -> (losses, params
    as {name: numpy})."""
    ds = jdata.synthetic_dataset(N, T, density=2.0, churn=0.1,
                                 smoothing_mode=SMOOTH[model], window=W,
                                 seed=0)
    got = jst.train_streamed(
        _jcfg(model), ds.snapshots, ds.values, np.asarray(ds.frames),
        np.asarray(ds.labels), num_epochs=EPOCHS, overlap=False,
        params=_jparams(model), slice_len=slice_len)
    return tuple(got.losses), _named(got.params)


def _port_stream(model, slice_len=None, overlap=True, **kw):
    ds = _ds(model)
    return st.train_streamed(
        _tcfg(model), ds.snapshots, ds.values, ds.frames, ds.labels,
        num_epochs=EPOCHS, overlap=overlap, slice_len=slice_len,
        params=_tparams(_jparams(model)), device="cpu", **kw)


# ------------------------------------------------ parity with JAX ----------

@pytest.mark.parametrize("slice_len", [None, 2])
@pytest.mark.parametrize("model", MODELS)
def test_train_streamed_matches_jax(model, slice_len):
    want_losses, want_params = _jax_stream(model, slice_len)
    got = _port_stream(model, slice_len)
    assert len(got.losses) == EPOCHS * T // (slice_len or 1)
    np.testing.assert_allclose(got.losses, want_losses, rtol=RTOL)
    got_params = _port_named(got.params)
    assert set(got_params) == set(want_params)
    for k, v in want_params.items():
        np.testing.assert_allclose(got_params[k], v, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("model", MODELS)
def test_first_step_gradients_match_jax(model):
    """``slice_value_and_grad`` on the first reconstructed snapshot equals
    ``jax.value_and_grad`` of the reference step's loss, carries closed
    over, at 1e-5 — ``w0``'s zero gradient included."""
    ds = _ds(model)
    max_edges = enc.padded_max_edges(ds.snapshots)
    item, frame, lab = next(st.host_stream(
        ds.snapshots, ds.values, ds.frames, ds.labels, N, max_edges,
        T // NB))
    assert isinstance(item, gd.FullSnapshot)      # a block's first step
    jp, jcfg = _jparams(model), _jcfg(model)
    je, jmask, jv = (jnp.asarray(x) for x in (item.edges, item.mask,
                                              item.values))
    jcarries = jm.init_carries(jcfg, jp)

    def loss_fn(p):
        z, _ = jst.advance_slice(jcfg, p, jcarries, jnp.asarray(frame)[None],
                                 je[None], jmask[None], jv[None], 0)
        return jnp.mean(jst.slice_nll(p, z[0], jnp.asarray(lab)))

    want_loss, want_grads = jax.value_and_grad(loss_fn)(jp)
    tp = _tparams(jp)
    e, m, v = DeltaApplier(max_edges, "cpu").consume(stage_item(item, "cpu"))
    loss, grads, carries = st.slice_value_and_grad(
        _tcfg(model), tp, st.fresh_carries(_tcfg(model), tp),
        torch.from_numpy(frame)[None], e[None], m[None], v[None],
        torch.from_numpy(lab)[None], 0)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL)
    names = [k for k, _ in tp.named_parameters()]
    want = _named(want_grads)
    for name, g in zip(names, grads, strict=True):
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-5,
                                   err_msg=name)
    if model == "evolvegcn":
        for l in range(2):
            assert not want[f"layers.{l}.evolve.w0"].any()
    assert all(not c.requires_grad for c in _leaves(carries))


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree


@pytest.mark.parametrize("model", MODELS)
def test_overlap_on_and_off_are_bit_identical(model):
    """The prefetch thread is a pure schedule change: per-step losses and
    final parameters equal the inline path's exactly."""
    sync = _port_stream(model, overlap=False)
    over = _port_stream(model, overlap=True, prefetch_depth=3)
    assert sync.losses == over.losses
    assert sync.losses[-1] < sync.losses[0] + 1e-6     # it trains
    for a, b in zip(sync.params.parameters(), over.params.parameters(),
                    strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("model", MODELS)
def test_engine_streamed_matches_train_streamed_and_jax(model):
    """Engine streamed == the stream loop with the pipeline's block size,
    stats and max_edges (bit for bit), and == the JAX Engine's streamed
    fit from the same parameters at rtol 1e-5."""
    trace = dict(num_nodes=N, num_steps=T, density=2.0, churn=0.1,
                 smoothing_mode=SMOOTH[model], window=W)
    plan = dict(mode="streamed", num_epochs=EPOCHS)
    want = JEngine(JRunConfig(model=_jcfg(model), data=JTrace(**trace),
                              plan=JPlan(**plan), log_fn=_silent)).fit()
    p0 = jm.init_params(jax.random.PRNGKey(0), _jcfg(model))
    ds = SyntheticTrace(**trace).build()
    pipe = data.DTDGPipeline(ds, nb=NB, device="cpu")
    got = Engine(RunConfig(model=_tcfg(model),
                           data=InMemoryDTDG(ds, pipeline=pipe),
                           plan=ExecutionPlan(**plan), log_fn=_silent),
                 params=_tparams(p0), device="cpu").fit()
    ref = st.train_streamed(
        _tcfg(model), ds.snapshots, ds.values, ds.frames, ds.labels,
        block_size=pipe.bsize, num_epochs=EPOCHS, stats=pipe.stream_stats,
        max_edges=pipe.max_edges, params=_tparams(p0), device="cpu")
    assert got.losses == ref.losses
    for a, b in zip(got.state.params.parameters(), ref.params.parameters(),
                    strict=True):
        assert torch.equal(a, b)
    np.testing.assert_allclose(got.losses, want.losses, rtol=RTOL)
    assert got.state.step == want.state.step == EPOCHS * T
    assert got.transfer_report == want.transfer_report
    assert got.stream_report is not None and got.stream_report.resyncs == 0
    assert pipe._batch is None          # the stream never builds the batch


def test_streamed_plan_keeps_the_references_rules():
    with pytest.raises(ValueError, match="single-device"):
        ExecutionPlan(mode="streamed", shards=2).validate()
    with pytest.raises(ValueError, match="prefetch_depth"):
        ExecutionPlan(mode="streamed", prefetch_depth=0).validate()
    ExecutionPlan(mode="streamed", num_epochs=3, overlap=False).validate()


def test_streamed_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")
    ds = _ds("tmgcn")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.train_streamed(_tcfg("tmgcn"), ds.snapshots, ds.values,
                          ds.frames, ds.labels)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PrefetchIterator(iter([]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(RunConfig(model=_tcfg("tmgcn"), data=InMemoryDTDG(ds),
                         plan=ExecutionPlan(mode="streamed")))


# ---------------------------------------------- gradients and carries ------

def test_evolvegcn_w0_is_unchanged_and_no_carry_aliases_a_parameter():
    """JAX gives ``w0`` a zero gradient in this schedule (its carry is
    closed over), so AdamW without weight decay leaves it bit-unchanged;
    the port's carries are clones, never the parameter."""
    p0 = _tparams(_jparams("evolvegcn"))
    w0 = [p0["layers"][l]["evolve"]["w0"].detach().clone() for l in range(2)]
    got = _port_stream("evolvegcn")
    for l in range(2):
        assert torch.equal(got.params["layers"][l]["evolve"]["w0"], w0[l])
    other = got.params["layers"][0]["evolve"]["lstm"]["wx"]
    assert not torch.equal(other, p0["layers"][0]["evolve"]["lstm"]["wx"])


@pytest.mark.parametrize("model", MODELS)
def test_fresh_carries_share_no_storage_with_the_parameters(model):
    params = _tparams(_jparams(model))
    ptrs = {p.data_ptr() for p in params.parameters()}
    for c in _leaves(st.fresh_carries(_tcfg(model), params)):
        assert c.data_ptr() not in ptrs and not c.requires_grad


@pytest.mark.parametrize("model", MODELS)
def test_a_steps_backward_never_reaches_the_previous_step(model):
    """Each step's new carries are detached leaves: the next step's
    backward stops at them (it would otherwise run into the previous
    step's freed graph and raise), and no gradient lands on them."""
    ds = _ds(model)
    cfg, max_edges = _tcfg(model), enc.padded_max_edges(ds.snapshots)
    params = _tparams(_jparams(model))
    opt = adamw.init_state(params)
    step = st.make_stream_train_step(cfg, adamw.AdamWConfig(total_steps=T))
    applier = DeltaApplier(max_edges, "cpu")
    carries = st.fresh_carries(cfg, params)
    host = st.host_stream(ds.snapshots, ds.values, ds.frames, ds.labels, N,
                          max_edges, T // NB)
    for t, x in enumerate(itertools.islice(host, 4)):
        item, frame, lab = stage_item(x, "cpu")
        prev = list(_leaves(carries))
        params, opt, carries, loss = step(params, opt, carries, frame,
                                          *applier.consume(item), lab, t)
        assert loss.grad_fn is None
        for c in _leaves(carries):
            assert c.grad_fn is None and not c.requires_grad
        assert all(c.grad is None for c in prev)


@pytest.mark.parametrize("slice_len", [1, 2])
def test_stream_step_launch_counts_per_step(monkeypatch, slice_len):
    """What ``chip_smoke.py`` asserts on the card, counted here on the plain
    versions the same wrappers reach.  TM-GCN with L layers over a slice
    of k snapshots: the aggregate runs L k times forward and (L - 1) k
    times backward (the frames need no gradient); the M-product L times
    forward and L times backward, each transposed band on the slice's k
    rows only (the detached prefix carry needs no gradient); 2 k CSR
    builds a step (each snapshot's forward and transposed CSR)."""
    calls = {"spmm": 0, "ttm": 0, "ttm_t": 0}
    ttm_t_args = set()

    def counted(key, fn):
        def call(*a):
            calls[key] += 1
            if key == "ttm_t":
                ttm_t_args.add((a[0].shape[0], a[3], a[4]))
            return fn(*a)
        return call

    for key, mod, name in (("spmm", spmm_ops, "segment_spmm_csr_ref"),
                           ("ttm", mp_ops, "banded_ttm_ref"),
                           ("ttm_t", mp_ops, "banded_ttm_t_ref")):
        monkeypatch.setattr(mod, name, counted(key, getattr(mod, name)))
    monkeypatch.setattr(spmm_ops, "csr_builds", 0)
    cfg = tm.DynGNNConfig(model="tmgcn", num_nodes=N, num_steps=T,
                          window=5, checkpoint_blocks=NB)
    ds = data.synthetic_dataset(N, T, density=2.0, churn=0.1,
                                smoothing_mode="mproduct", window=5)
    per_step = []

    def log(_msg):
        per_step.append((dict(calls), spmm_ops.csr_builds))

    st.train_streamed(cfg, ds.snapshots, ds.values, ds.frames, ds.labels,
                      slice_len=slice_len, log_every=1, log_fn=log,
                      device="cpu")
    layers, k = cfg.num_layers, slice_len
    assert len(per_step) == T // k
    for s, (c, builds) in enumerate(per_step, start=1):
        assert c == {"spmm": s * (layers * k + (layers - 1) * k),
                     "ttm": s * layers, "ttm_t": s * layers}, s
        assert builds == s * 2 * k
    # (rows, lead, write_lead): the slice's k rows after the 4-row
    # prefix, slice rows only
    assert ttm_t_args == {(k, cfg.window - 1, False)}


# ------------------------------------------------ prefetch and stacker -----

def test_prefetch_iterator_preserves_order_and_propagates_errors():
    items = list(range(20))
    out = list(PrefetchIterator(iter(items), stage_fn=lambda x: x * 2,
                                depth=3))
    assert out == [x * 2 for x in items]

    def bad():
        yield 1
        raise RuntimeError("encoder blew up")

    it = PrefetchIterator(bad(), stage_fn=lambda x: x, depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="encoder blew up"):
        list(it)
    with pytest.raises(StopIteration):      # terminated stays terminated
        next(it)


def test_prefetch_iterator_close_unblocks_abandoned_worker():
    it = PrefetchIterator(itertools.count(), stage_fn=lambda x: x, depth=2)
    assert next(it) == 0
    it.close()
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_worker_exception_before_first_next():
    def dead():
        raise RuntimeError("dead on arrival")
        yield  # pragma: no cover

    it = PrefetchIterator(dead(), stage_fn=lambda x: x, depth=2)
    with pytest.raises(RuntimeError, match="dead on arrival"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_stage_fn_exception_propagates():
    def boom(x):
        if x == 3:
            raise ValueError("stage failed")
        return x

    it = PrefetchIterator(iter(range(10)), stage_fn=boom, depth=2)
    assert [next(it), next(it), next(it)] == [0, 1, 2]
    with pytest.raises(ValueError, match="stage failed"):
        list(it)


def test_prefetch_close_releases_staged_buffers_and_is_idempotent():
    staged: list[int] = []

    def stage(x):
        staged.append(x)
        return x

    it = PrefetchIterator(itertools.count(), stage_fn=stage, depth=3)
    assert next(it) == 0
    it.close()
    it.close()                      # idempotent
    assert not it._thread.is_alive()
    assert it._q.qsize() == 0       # staged buffers dropped
    assert len(staged) >= 1         # the worker really was ahead
    with pytest.raises(StopIteration):
        next(it)
    with PrefetchIterator(itertools.count(), stage_fn=lambda x: x,
                          depth=2) as cm:
        assert next(cm) == 0
    assert not cm._thread.is_alive()


def _stream(seed=0):
    snaps = generate.evolving_dynamic_graph(96, 16, 3.0, churn=0.15,
                                            seed=seed)
    max_edges = enc.padded_max_edges(snaps)
    return (enc.encode_stream_fast(snaps, None, 96, max_edges, 4),
            max_edges)


def _decoded(stream, max_edges):
    e = torch.zeros((max_edges, 2), dtype=torch.int32)
    m = torch.zeros((max_edges,), dtype=torch.float32)
    out = []
    for item in stream:
        if isinstance(item, gd.FullSnapshot):
            e, m = torch.from_numpy(item.edges), torch.from_numpy(item.mask)
        else:
            e, m = gd.apply_delta(e, m, *(torch.from_numpy(getattr(item, f))
                                          for f in ("drop_pos", "drop_mask",
                                                    "add_edges",
                                                    "add_mask")))
        out.append((e.clone(), m.clone()))
    return out


def test_prefetch_side_stream_path_reconstructs_the_stream():
    """The default staging (``SideStream``; on the CPU, ``stage_item``)
    through the prefetch thread into the ring reproduces the decoded
    stream exactly."""
    stream, max_edges = _stream()
    want = _decoded(stream, max_edges)
    staged = SideStream("cpu").stage(stream[0])
    assert staged.ready is None and isinstance(staged.item.edges,
                                               torch.Tensor)
    applier = DeltaApplier(max_edges, "cpu")
    got = PrefetchIterator(iter(stream), depth=2, device="cpu")
    for item, (we, wm) in zip(got, want, strict=True):
        e, m, _ = applier.consume(item)
        assert torch.equal(e, we) and torch.equal(m, wm)


def test_slot_stacker_copies_survive_the_next_consume():
    """``SlotStacker.put`` copies the ring's views before the next
    ``consume`` overwrites them: the stacked block equals the decoded
    per-step sequence."""
    stream, max_edges = _stream(seed=3)
    want = _decoded(stream, max_edges)
    applier = DeltaApplier(max_edges, "cpu")
    stacker = SlotStacker(len(stream))
    for j, item in enumerate(stream):
        stacker.put(j, *applier.consume(stage_item(item, "cpu")))
    e_blk, m_blk, v_blk = stacker.arrays()
    assert e_blk.shape == (len(stream), max_edges, 2)
    for j, (we, wm) in enumerate(want):
        assert torch.equal(e_blk[j], we) and torch.equal(m_blk[j], wm)
    # the ring itself now holds only the last two snapshots
    assert not torch.equal(applier.current[0], e_blk[0])


def test_round_host_stream_groups_and_refuses_a_remainder():
    steps = [(i, np.full((2, 1), i), np.full(2, i)) for i in range(6)]
    rounds = list(st.round_host_stream(iter(steps), 3))
    assert [r[0] for r in rounds] == [(0, 1, 2), (3, 4, 5)]
    assert rounds[1][1].shape == (3, 2, 1)
    with pytest.raises(ValueError, match="not divisible"):
        list(st.round_host_stream(iter(steps[:5]), 3))


# ------------------------------------------------------------ tracing ------

@pytest.mark.parametrize("fence", [True, False])
def test_spans_release_what_they_fenced(fence):
    """A recorded span or stopwatch holds no reference to the tensors it
    was asked to fence, fencing or not: a host-clock traced run must not
    keep each step's staged values and CSRs alive in the span ring."""
    tracer = obs.configure(enabled=True, fence=fence)
    try:
        t, u = torch.ones(4), torch.ones(4)
        refs = weakref.ref(t), weakref.ref(u)
        with obs.span("a") as sp:
            sp.fence((t, [t]))
        with obs.stopwatch("b") as sw:
            sw.fence(u)
        del t, u
        assert [r() for r in refs] == [None, None]
        assert [s.name for s in tracer.spans()] == ["a", "b"]
    finally:
        obs.configure(enabled=False)


@pytest.mark.parametrize("overlap", [True, False])
def test_traced_epoch_records_every_phase_once_a_step(overlap):
    """The spans ``chip_smoke.py`` reads for the per-snapshot breakdown:
    one encode, apply, CSR-pair and step span a snapshot, and the stage
    and wait spans of the loop that ran."""
    tracer = obs.configure(enabled=True)
    try:
        _port_stream("tmgcn", overlap=overlap)
    finally:
        obs.configure(enabled=False)
    names = [s.name for s in tracer.spans()]
    steps = EPOCHS * T
    for name in ("stream.encode", "stream.apply", "stream.csr_pair",
                 "stream.step"):
        assert names.count(name) == steps, name
    staged = "prefetch.stage" if overlap else "stream.stage"
    assert names.count(staged) == steps
    # the consumer's last wait is the one that finds the stream's end
    assert names.count("prefetch.wait") == (steps + EPOCHS if overlap
                                            else 0)


# ---------------------------------------------------------- launcher -------

def test_launcher_stream_prints_the_references_line(capsys):
    launch_train.main(["--arch", "paper_dyngnn", "--stream", "--device",
                       "cpu"])
    out = capsys.readouterr().out
    assert "streamed 16 snapshot steps, final loss " in out
    assert out.rstrip().endswith(" vs naive") and "transfer ratio" in out
    launch_train.main(["--arch", "tmgcn", "--stream", "--no-overlap",
                       "--epochs", "2", "--device", "cpu"])
    assert "streamed 32 snapshot steps" in capsys.readouterr().out
