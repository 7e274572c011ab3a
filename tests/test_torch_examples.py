"""The port's single-process examples (``examples/torch/quickstart.py``,
``serve_dyngnn.py``, ``serve_lm.py``) held to the unchanged JAX examples.

Each test runs the JAX example in a subprocess on the CPU and parses the
lines it prints, then runs the twin in this process at ``device="cpu"``
from the same initial parameters (the JAX init, through
``repro_torch.convert``: the port draws its own from a seed) and compares
the twin's returned numbers with those lines: byte counts, shapes, counts
and tokens exactly; losses within half a unit of the last printed digit
plus rtol 1e-5; accuracy exactly at its three printed decimals.  The twin
prints the same lines, in the same format.  serve_dyngnn's scores, of
which the example prints only the shapes, are held at 1e-4 to the JAX
``ServeEngine`` serving the twin's trained parameters.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch
import torch.distributed as dist
from examples_parity import (assert_log_losses, assert_loss, find,
                             jax_dyngnn_params, jax_example, twin)

TWINS = ("quickstart", "partition_compare", "serve_dyngnn", "serve_lm",
         "train_dyngnn_distributed")
TOL_SCORES = 1e-4


# ------------------------------------------------------------ quickstart ---

QUICKSTART_CFG = dict(model="tmgcn", num_nodes=128, num_steps=16, feat_in=2,
                      hidden=6, out_dim=6, window=3, checkpoint_blocks=2)


def test_quickstart_matches_the_jax_example():
    want = jax_example("quickstart")
    _, params = jax_dyngnn_params(**QUICKSTART_CFG)
    lines: list[str] = []
    got = twin("quickstart").run("cpu", params=params, echo=lines.append)
    pat = {"transfer": r"graph-difference transfer: ([\d,]+) bytes vs naive "
                       r"([\d,]+) \(([\d.]+)x less\)$",
           "loss": r"loss: (\d\.\d+) -> (\d\.\d+)$",
           "acc": r"link-prediction accuracy: (\d\.\d{3})$"}
    m = find(want, pat["transfer"])
    assert got["graph_diff"] == int(m.group(1).replace(",", ""))
    assert got["naive"] == int(m.group(2).replace(",", ""))
    assert f"{1 / got['ratio']:.2f}" == m.group(3)
    m = find(want, pat["loss"])
    assert_loss(got["losses"][0], m.group(1))
    assert_loss(got["losses"][-1], m.group(2))
    assert len(got["losses"]) == 60
    assert f"{got['accuracy']:.3f}" == find(want, pat["acc"]).group(1)
    assert assert_log_losses(want, r"step (\d+) loss (\S+)$",
                             got["losses"]) == 6
    # the twin prints the same lines: its three in order, the same counts
    mine = [next(ln for ln in lines if re.match(p, ln))
            for p in pat.values()]
    assert lines[-3:] == mine
    assert find(lines, pat["transfer"]).group(0) == \
        find(want, pat["transfer"]).group(0)


# ---------------------------------------------------------- serve_dyngnn ---

SERVE_N, SERVE_W = 64, 16
SERVE_SUMMARY = (r"family=dyngnn; ingested (\d+) events over (\d+) windows "
                 r"\(\d+ ev/s, (\d+) resyncs\); (\d+) queries in (\d+) "
                 r"batches \(p50 [\d.]+ ms, p95 [\d.]+ ms\)$")


def jax_serve_scores(tree, block_size: int, max_edges: int):
    """The JAX example's serving half, on the parameters ``tree``: the same
    stream, chunks, advances and queries -> (node scores, link scores)."""
    from repro.core import ctdg
    from repro.core.models import DynGNNConfig
    from repro.run import IngestSpec, ServeConfig, ServeEngine

    n, w = SERVE_N, SERVE_W
    stream = ctdg.synthetic_ctdg(n, 800, seed=0)
    cfg = DynGNNConfig(model="tmgcn", num_nodes=n, num_steps=w, window=3,
                       checkpoint_blocks=2)
    spec = IngestSpec(
        num_windows=w,
        time_range=(float(stream.time.min()), float(stream.time.max())),
        block_size=block_size, max_edges=max_edges)
    eng = ServeEngine(ServeConfig(model=cfg, ingest=spec, seed=0),
                      params=tree)
    ev = stream.sorted()
    chunk = max(len(ev) // 4, 1)
    for lo in range(0, len(ev), chunk):
        sl = slice(lo, lo + chunk)
        eng.ingest(ctdg.EventStream(ev.src[sl], ev.dst[sl], ev.time[sl],
                                    ev.kind[sl], n))
        arrived = int(spec.window_of(ev.time[sl.stop - 1 if sl.stop
                                             <= len(ev) else -1]))
        while eng.ingester.next_window < min(arrived, w):
            eng.advance()
    eng.advance_all()
    return (np.asarray(eng.query_nodes(np.arange(min(8, n)))),
            np.asarray(eng.query_links(np.array([[0, 1], [2, 3]]))))


def test_serve_dyngnn_matches_the_jax_example():
    import jax

    from repro_torch import convert

    want = jax_example("serve_dyngnn")
    tree, params = jax_dyngnn_params(
        model="tmgcn", num_nodes=SERVE_N, num_steps=SERVE_W, window=3,
        checkpoint_blocks=2)
    lines: list[str] = []
    got = twin("serve_dyngnn").run(device="cpu", params=params,
                                   echo=lines.append)
    assert_loss(got["losses"][-1],
                find(want, r"trained: final loss (\S+)$").group(1))
    assert assert_log_losses(want, r"stream step (\d+) loss (\S+)$",
                             got["losses"]) == 4
    shapes = r"node scores \((\d+), (\d+)\), link scores \((\d+), (\d+)\)$"
    m = find(want, shapes)
    assert got["node_scores"].shape == (int(m.group(1)), int(m.group(2)))
    assert got["link_scores"].shape == (int(m.group(3)), int(m.group(4)))
    assert find(lines, shapes).group(0) == m.group(0)
    m = find(want, SERVE_SUMMARY)
    assert (got["events"], got["windows"], got["resyncs"], got["queries"],
            got["query_batches"]) == tuple(int(g) for g in m.groups())
    assert find(lines, SERVE_SUMMARY).groups() == m.groups()

    # the scores: the JAX engine serving the twin's trained parameters
    named = convert.params_to_numpy(got["params"])
    trained = jax.tree_util.tree_map_with_path(
        lambda k, _: named[jax.tree_util.keystr(k, simple=True,
                                                separator=".")], tree)
    nodes, links = jax_serve_scores(trained, got["block_size"],
                                    got["max_edges"])
    np.testing.assert_allclose(got["node_scores"], nodes, atol=TOL_SCORES)
    np.testing.assert_allclose(got["link_scores"], links, atol=TOL_SCORES)


# -------------------------------------------------------------- serve_lm ---

def test_serve_lm_matches_the_jax_example():
    import jax

    from repro.configs import registry
    from repro.models import lm
    from repro_torch import convert

    want = jax_example("serve_lm")
    jcfg = registry.get_arch("yi-6b").make_smoke_config()
    params = convert.lm_params_from_jax(jax.tree.map(
        np.asarray, lm.init_lm_params(jax.random.PRNGKey(0), jcfg)))
    lines: list[str] = []
    got = twin("serve_lm").run(device="cpu", params=params,
                               echo=lines.append)
    assert got["tokens"].shape == (4, 32)
    for b in range(4):
        req = rf"  request {b}: generated \[([\d, ]+)\] \.\.\.$"
        m = find(want, req)
        assert got["tokens"][b][:12].tolist() == \
            [int(v) for v in m.group(1).split(",")]
        assert find(lines, req).group(0) == m.group(0)
    summary = (r"family=lm; arch=yi-6b; (\d+) queries in (\d+) batches "
               r"\(p50 [\d.]+ ms, p95 [\d.]+ ms\); (\d+) tokens$")
    m = find(want, summary)
    assert (got["queries"], got["query_batches"], got["tokens_generated"]
            ) == tuple(int(g) for g in m.groups())
    assert find(lines, summary).groups() == m.groups()
    assert lines[0] == want[0] == "arch=yi-6b (smoke config) batch=4"


# --------------------------------------------------------- package rules ---

@pytest.mark.parametrize("name", TWINS)
def test_twin_defaults_to_cuda_and_raises_without_it(name, monkeypatch):
    """``main([])`` asks for the card: on a host without one it raises
    before it builds an engine or a batch, and leaves no process group
    open."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")
    mod = twin(name)

    def ran(*_a, **_k):
        raise AssertionError(f"{name} ran without a card")

    for entry in ("Engine", "ServeEngine", "losses"):
        if hasattr(mod, entry):
            monkeypatch.setattr(mod, entry, ran)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
    assert not dist.is_initialized()
