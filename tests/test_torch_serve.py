"""The port's serving engine held to the JAX package's, plus the port's
package rules.

* ``repro_torch.serve.ServeEngine(device="cpu")`` and
  ``repro.serve.ServeEngine`` fed the same pushed events and the same
  parameters (``repro``'s ``init_params`` through
  ``repro_torch.convert.params_from_jax``) give the same node scores and
  link logits after EVERY window, and the same resident carries, at atol
  1e-5 (the reference's own online == offline tolerance,
  ``tests/test_serve.py``);
* fresh carries, the query-before-advance error, the batcher's bucket
  padding and the unported families behave as in the reference;
* nothing in ``src/repro_torch`` or ``chip_smoke.py`` imports ``jax`` or
  ``repro``, and the entry points refuse to drop quietly to the CPU.
"""

import re
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import ctdg as jctdg
from repro.core import models as jm
from repro.serve import IngestSpec as JSpec
from repro.serve import ServeConfig as JConfig
from repro.serve import ServeEngine as JEngine
from repro.serve import fresh_carries as jfresh
from repro_torch import convert, obs, sanitize
from repro_torch.configs import registry
from repro_torch.core import ctdg
from repro_torch.core import models as tm
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.mproduct import ops as mp_ops
from repro_torch.kernels.segment_spmm import ops as spmm_ops
from repro_torch.serve import (IngestSpec, QueryBatcher, ServeConfig,
                               ServeEngine, fresh_carries)
from repro_torch.stream.prefetch import DeltaApplier, stage_item

TOL = 1e-5
N, W = 40, 12
ROOT = Path(__file__).resolve().parent.parent


def _spec_kw(stream, **kw):
    return dict(num_windows=W, time_range=(float(stream.time.min()),
                                           float(stream.time.max())),
                block_size=4, max_edges=512, **kw)


def _engines(model, seed=1, use_pallas=False, policy="snapshot"):
    """A JAX engine (with or without its Pallas kernels, interpret mode on
    the CPU) and a CPU port engine on the same params and spec."""
    stream = jctdg.synthetic_ctdg(N, 500, delete_frac=0.25, seed=seed)
    jcfg = jm.DynGNNConfig(model=model, num_nodes=N, num_steps=W, window=3,
                           use_pallas=use_pallas)
    tcfg = tm.DynGNNConfig(model=model, num_nodes=N, window=3)
    params = jm.init_params(jax.random.PRNGKey(7), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params))
    kw = _spec_kw(stream, policy=policy)
    jeng = JEngine(JConfig(model=jcfg, ingest=JSpec(**kw)), params=params)
    teng = ServeEngine(ServeConfig(model=tcfg, ingest=IngestSpec(**kw)),
                       params=tparams, device="cpu")
    return stream, jeng, teng


def _push_both(stream, jeng, teng, chunk=123):
    for lo in range(0, len(stream), chunk):
        sl = slice(lo, lo + chunk)
        jeng.ingest(jctdg.EventStream(stream.src[sl], stream.dst[sl],
                                      stream.time[sl], stream.kind[sl], N))
        teng.ingest(ctdg.EventStream(stream.src[sl], stream.dst[sl],
                                     stream.time[sl], stream.kind[sl], N))


@pytest.mark.parametrize("model,use_pallas,policy", [
    ("tmgcn", False, "snapshot"), ("tmgcn", True, "window"),
    ("cdgcn", True, "snapshot"), ("evolvegcn", False, "snapshot")])
def test_served_scores_match_jax_after_every_window(model, use_pallas,
                                                    policy):
    stream, jeng, teng = _engines(model, use_pallas=use_pallas,
                                  policy=policy)
    _push_both(stream, jeng, teng)
    ids = np.arange(N)
    pairs = np.array([[0, 1], [3, 9], [N - 1, 0], [7, 7]])
    seen = []
    for _ in range(W):
        jeng.advance()
        teng.advance()
        got = teng.query_nodes(ids)
        np.testing.assert_allclose(got, jeng.query_nodes(ids), atol=TOL)
        np.testing.assert_allclose(teng.query_links(pairs),
                                   jeng.query_links(pairs), atol=TOL)
        for a, b in zip(jax.tree.leaves(convert.carries_to_numpy(
                teng.carries)), jax.tree.leaves(
                jax.tree.map(np.asarray, jeng.carries)), strict=True):
            np.testing.assert_allclose(a, b, atol=TOL)
        seen.append(got)
    # the state really moved window to window
    assert any(np.abs(seen[t] - seen[t + 1]).max() > 0 for t in range(W - 1))
    r, jr = teng.result(), jeng.result()
    assert (r.events_ingested, r.windows_advanced, r.resyncs) == \
        (jr.events_ingested, jr.windows_advanced, jr.resyncs)
    assert r.queries == 2 * W and r.query_batches == 2 * W
    assert np.isfinite(r.p50_ms) and np.isfinite(r.p95_ms)


def test_cold_query_replays_to_the_warm_scores():
    stream = ctdg.synthetic_ctdg(N, 400, delete_frac=0.25, seed=2)
    cfg = tm.DynGNNConfig(model="tmgcn", num_nodes=N, window=3)
    eng = ServeEngine(ServeConfig(model=cfg, ingest=IngestSpec(
        **_spec_kw(stream))), keep_history=True, device="cpu")
    eng.ingest(stream)
    eng.advance(5)
    ids = np.arange(0, N, 3)
    np.testing.assert_allclose(eng.cold_query_nodes(ids),
                               eng.query_nodes(ids), atol=TOL)


def test_model_path_runs_through_the_kernel_wrappers(monkeypatch):
    """No flag picks a path: the served model reaches each kernel's one
    plain version through its wrapper (on the card, the kernel)."""
    calls = {"spmm": 0, "ttm": 0}

    def counted(key, fn):
        def wrapped(*args):
            calls[key] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(spmm_ops, "segment_spmm_csr_ref",
                        counted("spmm", spmm_ops.segment_spmm_csr_ref))
    monkeypatch.setattr(mp_ops, "banded_ttm_ref",
                        counted("ttm", mp_ops.banded_ttm_ref))
    stream = ctdg.synthetic_ctdg(N, 300, delete_frac=0.25, seed=4)
    cfg = tm.DynGNNConfig(model="tmgcn", num_nodes=N, window=3)
    assert not hasattr(cfg, "use_kernels")
    eng = ServeEngine(ServeConfig(model=cfg, ingest=IngestSpec(
        **_spec_kw(stream))), device="cpu")
    eng.ingest(stream)
    eng.advance(3)
    # one of each per layer per window
    assert calls == {"spmm": 3 * cfg.num_layers, "ttm": 3 * cfg.num_layers}


@pytest.mark.parametrize("model", ["tmgcn", "cdgcn", "evolvegcn"])
def test_serving_window_builds_one_csr_per_snapshot(model, monkeypatch):
    """A window is one snapshot: its CSR is built once and both layers'
    aggregates read it (on the card: 16 builds and 32 launches in 16
    windows)."""
    stream = ctdg.synthetic_ctdg(N, 300, delete_frac=0.25, seed=5)
    cfg = tm.DynGNNConfig(model=model, num_nodes=N, window=3)
    eng = ServeEngine(ServeConfig(model=cfg, ingest=IngestSpec(
        **_spec_kw(stream))), device="cpu")
    eng.ingest(stream)
    for k in range(1, 4):
        monkeypatch.setattr(spmm_ops, "csr_builds", 0)
        eng.advance(1)
        assert spmm_ops.csr_builds == 1, f"window {k}"


@pytest.mark.parametrize("model", ["tmgcn", "cdgcn", "evolvegcn"])
def test_fresh_carries_match_jax_and_own_their_memory(model):
    jcfg = jm.DynGNNConfig(model=model, num_nodes=N, window=3)
    params = jm.init_params(jax.random.PRNGKey(2), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params))
    tcfg = tm.DynGNNConfig(model=model, num_nodes=N, window=3)
    got = fresh_carries(tcfg, tparams)
    want = jax.tree.map(np.asarray, jfresh(jcfg, params))
    for a, b in zip(jax.tree.leaves(convert.carries_to_numpy(got)),
                    jax.tree.leaves(want), strict=True):
        np.testing.assert_array_equal(a, b)
    # no carry aliases a parameter (EvolveGCN's starts as w0 itself)
    ptrs = {p.data_ptr() for p in tparams.parameters()}
    assert not any(t.data_ptr() in ptrs for t in jax.tree.leaves(got))


def test_traced_advance_records_each_phase_and_counts_windows():
    stream = ctdg.synthetic_ctdg(N, 300, delete_frac=0.25, seed=3)
    cfg = tm.DynGNNConfig(model="tmgcn", num_nodes=N, window=3)
    assert obs.span("x") is obs.NULL_SPAN          # disabled: a no-op
    tracer = obs.configure(enabled=True)
    try:
        eng = ServeEngine(ServeConfig(model=cfg, ingest=IngestSpec(
            **_spec_kw(stream))), device="cpu")
        eng.ingest(stream)
        eng.advance(3)
        eng.query_nodes([1, 2])
        r = eng.result()
    finally:
        obs.configure(enabled=False)
    names = [sp.name for sp in tracer.spans()]
    for phase in ("serve.encode", "serve.stage", "serve.apply",
                  "serve.step", "serve.window"):
        assert names.count(phase) == 3, phase
    assert r.metrics["counters"]["serve.windows_advanced"] == 3
    assert r.metrics["counters"]["serve.queries"] == 1
    assert r.metrics["spans"]["serve.step"]["count"] == 3
    assert r.ingest_seconds > 0 and r.events_ingested == len(stream)


def test_query_before_first_advance_raises():
    stream = ctdg.synthetic_ctdg(N, 200, seed=0)
    cfg = tm.DynGNNConfig(model="tmgcn", num_nodes=N, window=3)
    eng = ServeEngine(ServeConfig(model=cfg,
                                  ingest=IngestSpec(**_spec_kw(stream))),
                      device="cpu")
    with pytest.raises(ValueError, match="no resident state"):
        eng.query_nodes([0, 1])
    with pytest.raises(ValueError, match="no resident state"):
        eng.submit_links([[0, 1]])


def test_query_batcher_pads_to_buckets_without_leaking():
    calls = []

    def run_fn(padded):
        calls.append(padded.shape[0])
        return padded * 2.0

    qb = QueryBatcher(run_fn, batch_sizes=(2, 4), queue_depth=8)
    a = qb.submit(np.array([1.0]))
    b = qb.submit(np.array([2.0, 3.0]))
    qb.flush()
    np.testing.assert_allclose(a.scores, [2.0])
    np.testing.assert_allclose(b.scores, [4.0, 6.0])
    assert calls == [4]                 # 3 rows -> one padded-4 batch
    np.testing.assert_allclose(qb.query(np.arange(10.0)),
                               2.0 * np.arange(10.0))
    assert calls == [4, 4, 4, 2]        # 10 rows -> 4 + 4 + 2
    assert qb.stats.queries == 3 and qb.stats.rows == 13
    # a full queue flushes first
    qb2 = QueryBatcher(lambda p: p, batch_sizes=(1, 2), queue_depth=2)
    p1, p2 = qb2.submit(np.array([1.0])), qb2.submit(np.array([2.0]))
    p3 = qb2.submit(np.array([3.0]))
    assert p1.done and p2.done and not p3.done


def test_unported_families_and_wires_raise():
    assert registry.get_arch("din").family == "recsys"
    eng = ServeEngine(ServeConfig(arch="din"), device="cpu")
    assert eng.family == "recsys" and eng.score(batch_size=2).shape == (2, 2)
    cfg = registry.get_arch("paper_dyngnn").make_config()
    assert (cfg.model, cfg.feat_in, cfg.hidden, cfg.out_dim,
            cfg.num_layers, cfg.window) == ("tmgcn", 2, 6, 6, 2, 5)
    with pytest.raises(ValueError, match="needs ServeConfig.ingest"):
        ServeEngine(ServeConfig(model=cfg), device="cpu")


def test_thread_affinity_guard_rejects_a_second_thread():
    guard = sanitize.ThreadAffinityGuard("t")
    errors = []

    def other():
        try:
            with guard:
                pass
        except RuntimeError as e:
            errors.append(e)

    with guard:
        with guard:                     # re-entrant for the owner
            th = threading.Thread(target=other)
            th.start()
            th.join()
    assert len(errors) == 1 and guard.trips == 1
    with guard:                         # released after the outer exit
        pass


# --------------------------------------------------------- package rules ----

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)|"
    r"from\s+repro(\.|\s+import\b))", re.MULTILINE)


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += sorted((ROOT / "examples" / "torch").glob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    scanned = {f.relative_to(ROOT).as_posix() for f in files}
    assert {f"examples/torch/{m}.py" for m in (
        "quickstart", "partition_compare", "serve_dyngnn", "serve_lm",
        "train_dyngnn_distributed")} <= scanned
    assert {f"src/repro_torch/{m}.py" for m in (
        "graph/segment", "models/gnn/common", "models/gnn/gatedgcn",
        "models/gnn/pna", "models/gnn/schnet", "models/gnn/so3",
        "models/gnn/equiformer_v2", "configs/gatedgcn", "configs/pna",
        "configs/schnet", "configs/equiformer_v2",
        "launch/steps")} <= scanned
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert hits == []
    # the pattern itself catches what it must and passes the port's name
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from repro.core import ctdg")
    assert _FORBIDDEN.search("from repro import obs")
    assert not _FORBIDDEN.search("from repro_torch.core import ctdg")


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")
    cfg = tm.DynGNNConfig(model="tmgcn", num_nodes=N, window=3)
    spec = IngestSpec(num_windows=2, time_range=(0.0, 1.0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(ServeConfig(model=cfg, ingest=spec))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeltaApplier(64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage_item(np.zeros(3, np.float32))
    for kernel in (spmm_ops.KERNEL, mp_ops.KERNEL, fd_ops.KERNEL):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            kernel.load()
