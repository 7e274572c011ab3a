"""The plain reference against the port's plain path at a tiny size, the
lower-precision control, and a run whose timed path is broken underneath
coming out not correct."""

import json
import time

import pytest
import torch

from perfbench import harness, judge
from perfbench.calibrate import unchanged
from perfbench.reference import common

ROOT = harness.ROOT
MODELS = ["tmgcn", "cdgcn"]
SEED = 2**31 + 17


def cell_of(model, traffic):
    cfg = json.loads((ROOT / "perfbench" / "configs" / f"{model}.json")
                     .read_text())
    return harness.Cell(f"test.{model}", 1, cfg, traffic)


@pytest.fixture
def limits(monkeypatch):
    """Limits between the CPU's sound readings (~1e-7) and the control's
    (>= 1e-6 on the loss, >= 1e-4 on the first gradient)."""
    lim = {"loss": 1e-6, "grad1": 1e-5, "delta3": 1e-5}
    monkeypatch.setattr(judge, "load_limits", lambda root, name: lim)
    return lim


@pytest.mark.parametrize("model", MODELS)
def test_reference_follows_the_port(model, tiny):
    cell = cell_of(model, tiny)
    _, params0, readings = harness.first_steps(cell, SEED, "cpu")
    ref = common.train(harness.reference_model(cell.cfg), cell.cfg, tiny,
                       SEED, params0)
    nums = judge.numbers(readings, ref)
    assert nums["loss"] < 1e-6, nums
    assert nums["grad1"] < 1e-5 and nums["delta3"] < 1e-5, nums
    assert ref["losses"][2] < ref["losses"][0]


@pytest.mark.parametrize("model", MODELS)
def test_control_and_faults_fail(model, tiny):
    """TF32 in the reference's place and half of the batch left out each
    read far above the port's sound run; a state left unchanged reads 1."""
    traffic = dict(tiny, nodes=400, edges_per_snapshot=1200)
    cell = cell_of(model, traffic)
    m = harness.reference_model(cell.cfg)
    _, params0, readings = harness.first_steps(cell, SEED, "cpu")
    data = common.graphs_of(SEED, traffic, "cpu")
    ref = common.train(m, cell.cfg, traffic, SEED, params0, data=data)
    sound = judge.numbers(readings, ref)
    ctl = judge.numbers(common.train(m, cell.cfg, traffic, SEED, params0,
                                     tf32=True, data=data), ref)
    half = judge.numbers(common.train(m, cell.cfg, traffic, SEED, params0,
                                      fault="half_batch", data=data), ref)
    assert ctl["grad1"] > 100 * max(sound["grad1"], 1e-9), (ctl, sound)
    assert half["loss"] > 100 * max(sound["loss"], 1e-9), (half, sound)
    still = judge.numbers(unchanged(ref), ref)
    assert still["delta3"] == 1.0 and still["grad1"] == 1.0


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-12,
                      3.14159265])
    r = common.round_tf32(x)
    assert r.tolist()[:4] == [1.0, 1.0, 1.0 + 4 * 2**-11, -1.0]
    assert abs(r[4] - x[4]) <= x[4] * 2**-11
    assert torch.equal(common.round_tf32(r), r)


def _run(model, traffic):
    cell = cell_of(model, traffic)
    return harness.run(cell, SEED, 0.2, False, time.time(), "cpu",
                       log=lambda m: None)


@pytest.mark.parametrize("model", MODELS)
def test_a_sound_run_is_correct(model, tiny, limits):
    assert _run(model, tiny)["correct"]


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(model, fault, tiny, limits,
                                      monkeypatch):
    """The port's step broken underneath: its update returning the state
    unchanged, or its loss the mean over half of the batch."""
    from repro_torch.core import models
    from repro_torch.optim import adamw

    if fault == "unchanged":
        monkeypatch.setattr(adamw, "apply_updates",
                            lambda cfg, params, grads, state, zero=None:
                            (params, state))
    else:
        nll = models.nll_loss

        def half(logits, labels, label_mask=None):
            n = logits.shape[-2] // 2
            return nll(logits[..., :n, :], labels[..., :n], label_mask)

        monkeypatch.setattr(models, "nll_loss", half)
    res = _run(model, tiny)
    assert not res["correct"], res["checks"]


class _ShrinkGrad(torch.autograd.Function):
    """Identity forward; the gradient handed back shrunk by ``share``."""

    @staticmethod
    def forward(ctx, u, share):
        ctx.share = share
        return u.view_as(u)

    @staticmethod
    def backward(ctx, g):
        return g * (1 - ctx.share), None


@pytest.mark.parametrize("model,workload", [("tmgcn", "tmgcn.epinions"),
                                            ("cdgcn", "cdgcn.weak_scale")])
def test_a_classifier_gradient_off_by_5e_4_is_not_correct(
        model, workload, tiny, monkeypatch):
    """The size of the error that the port's one float32 product over all
    T * N rows put into dL/dU on some seeds at epinions' size (4.6e-4 of
    the leaf, with every other leaf exact): the committed limits of the
    cells catch it."""
    from repro_torch.core import models

    def classify(params, z):
        u = _ShrinkGrad.apply(params["classifier"]["u"], 4.6e-4)
        return z @ u + params["classifier"]["b"]

    monkeypatch.setattr(models, "classify", classify)
    lim = judge.load_limits(ROOT, workload)
    monkeypatch.setattr(judge, "load_limits", lambda root, name: lim)
    res = _run(model, dict(tiny, nodes=400, edges_per_snapshot=1200))
    assert res["checks"]["grad1"]["value"] > lim["grad1"], res["checks"]
    assert not res["correct"]
