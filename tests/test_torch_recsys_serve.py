"""The port's recsys serving and training entry points on the CPU.

``ServeEngine.synthetic_requests`` byte-identical to the JAX engine's for
the same seed; ``ServeEngine.score`` equal to the JAX engine's at 1e-5 on
the same parameters (``convert.din_params_from_jax``); its counters,
``ServeResult`` and ``serve.score`` spans; the family guards (as in
``tests/test_serve.py``); the ``launch/serve.py`` shim's waves; the
launcher's ``--arch din`` (finite losses, equal to ``din_train_step``'s
on ``din_batch``) and its refusals; and, pinned, the reference launcher's
NaN after step 0, which the port's launcher does not share.
"""

import contextlib
import io
import math
import sys

import jax
import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert, obs
from repro_torch.configs import registry
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import steps
from repro_torch.launch import train as launch_train
from repro_torch.models import din
from repro_torch.serve import ServeConfig, ServeEngine


def _engines(seed: int = 3, batch: int = 4):
    jeng = JServeEngine(JServeConfig(arch="din", batch_sizes=(batch,),
                                     seed=seed))
    params = convert.din_params_from_jax(jax.tree.map(np.asarray,
                                                      jeng.params))
    teng = ServeEngine(ServeConfig(arch="din", batch_sizes=(batch,),
                                   seed=seed), params=params, device="cpu")
    return jeng, teng


def test_arch_resolves_to_the_recsys_smoke_config():
    spec = registry.get_arch("din")
    assert spec.family == "recsys"
    assert sorted(spec.shapes) == ["retrieval_cand", "serve_bulk",
                                   "serve_p99", "train_batch"]
    eng = ServeEngine(ServeConfig(arch="din"), device="cpu")
    assert eng.family == "recsys" and eng.model == spec.make_smoke_config()
    full = ServeEngine(ServeConfig(model=din.DINConfig(item_vocab=64,
                                                       user_vocab=64,
                                                       cate_vocab=8)),
                       device="cpu")
    assert full.family == "recsys" and full.model.embed_dim == 18
    assert full.score(batch_size=3).shape == (3, 2)


def test_synthetic_requests_are_the_reference_engines():
    jeng, teng = _engines(seed=11)
    for b in (4, 7, 4):
        want = jeng.synthetic_requests(b)
        got = teng.synthetic_requests(b)
        assert got.keys() == want.keys()
        for k, v in want.items():
            w = np.asarray(v)
            g = got[k].numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert g.tobytes() == w.tobytes(), k


def test_score_matches_the_reference_engine():
    jeng, teng = _engines(seed=3)
    for b in (4, 9):
        want = jeng.score(batch_size=b)
        got = teng.score(batch_size=b)
        assert got.shape == want.shape == (b, 2)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # an explicit batch, and the default wave (the last batch size)
    batch = teng.synthetic_requests(5)
    np.testing.assert_allclose(teng.score(batch),
                               din.forward(teng.params, batch)
                               .detach().numpy(), rtol=0, atol=0)
    assert teng.score().shape == (4, 2)


def test_score_counters_result_and_spans():
    tracer = obs.configure(enabled=True)
    try:
        eng = ServeEngine(ServeConfig(arch="din", batch_sizes=(2, 4),
                                      seed=0), device="cpu")
        eng.score(batch_size=3)
        eng.score()
        r = eng.result()
    finally:
        obs.configure(enabled=False)
    assert (r.family, r.arch, r.queries, r.query_batches) == (
        "recsys", "din", 7, 2)
    assert len(r.query_latencies_ms) == 2 and r.query_seconds > 0
    assert math.isfinite(r.p50_ms) and r.tokens_generated == 0
    assert r.metrics["counters"]["serve.queries"] == 7
    assert r.metrics["spans"]["serve.score"]["count"] == 2
    assert [sp.name for sp in tracer.spans()].count("serve.score") == 2
    assert "family=recsys; arch=din; 7 queries in 2 batches" in r.summary()


def test_family_guards():
    eng = ServeEngine(ServeConfig(arch="din", batch_sizes=(2,)),
                      device="cpu")
    with pytest.raises(ValueError, match="family"):
        eng.ingest(None)
    with pytest.raises(ValueError, match="family"):
        eng.generate()
    lm = ServeEngine(ServeConfig(arch="yi-6b", batch_sizes=(2,),
                                 prompt_len=4, max_tokens=2), device="cpu")
    with pytest.raises(ValueError, match="recsys family"):
        lm.score(batch_size=2)
    with pytest.raises(ValueError, match="DINConfig"):
        ServeEngine(ServeConfig(model=object()), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(ServeConfig(arch="din"))


def test_serve_shim_scores_din_waves(capsys):
    with pytest.warns(DeprecationWarning, match="deprecated"):
        launch_serve.main(["--arch", "din", "--device", "cpu", "--batch",
                           "3", "--requests", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in out] == ["wave 0", "wave 1"]
    assert "family=recsys; arch=din; 3 queries in 1 batches" in out[0]
    assert "6 queries in 2 batches" in out[1]


def test_launcher_trains_din_and_matches_the_train_step(capsys):
    launch_train.main(["--arch", "din", "--device", "cpu", "--steps", "10"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "done"
    assert [ln.split()[1] for ln in lines[:-1]] == [str(i)
                                                    for i in range(10)]
    got = [float(ln.split()[-1]) for ln in lines[:-1]]
    assert all(math.isfinite(x) for x in got)
    spec = registry.get_arch("din")
    cfg = spec.make_smoke_config()
    shape = steps.ShapeSpec("train_batch", "recsys_train",
                            {"batch": launch_train.DIN_SMOKE_BATCH})
    batch = steps.din_batch(cfg, shape)
    labels = batch.pop("labels")
    params, opt = steps.din_train_state(torch.Generator().manual_seed(0),
                                        cfg)
    step = steps.din_train_step()
    want = []
    for _ in range(10):
        params, opt, loss = step(params, opt, batch, labels)
        want.append(round(float(loss), 4))
    assert got == want


def test_launcher_refusals(monkeypatch):
    with pytest.raises(SystemExit, match="--stream configure the dyngnn"):
        launch_train.main(["--arch", "din", "--device", "cpu", "--stream",
                           "--steps", "1"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="does not divide the 2 processes"):
        launch_train.main(["--arch", "din", "--device", "cpu",
                           "--data-parallel", "3", "--steps", "1"])
    monkeypatch.delenv("WORLD_SIZE")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_train.main(["--arch", "din", "--steps", "1"])


def test_reference_launcher_goes_nan_and_the_port_does_not(monkeypatch,
                                                           capsys):
    """Pinned: the reference's launcher fills the cell's inputs with
    N(0, 0.1) draws -- AdamW's second moment too, so ``sqrt(v)`` is NaN
    where a draw is negative -- and its ids with 0 or 1; step 0 is finite,
    step 1 NaN.  The port's launcher starts from ``init_params``,
    ``init_state`` and ``din_batch``."""
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "din", "--steps",
                                      "2"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jtrain.main()
    ref = [ln.split()[-1] for ln in buf.getvalue().splitlines()
           if ln.startswith("step")]
    assert math.isfinite(float(ref[0])) and ref[1] == "nan"
    launch_train.main(["--arch", "din", "--device", "cpu", "--steps", "2"])
    port = [float(ln.split()[-1]) for ln in
            capsys.readouterr().out.splitlines() if ln.startswith("step")]
    assert len(port) == 2 and all(math.isfinite(x) for x in port)
