"""The port's static-GNN train step (``launch.steps.gnn_train_step``)
held to the JAX package on the CPU.

Three AdamW steps of ``gnn_train_step`` beside the reference's own
``cell.step`` from ``steps.build_cell(..., smoke=True,
shape_override=...)`` on ``make_host_mesh(data=2, model=1)`` -- two
replicas, ``tests/conftest.py``'s host devices -- from the same
parameters (the cell's init through ``params_from_jax``), the same AdamW
state and the same concrete batches (not the reference launcher's N(0,
0.1) fill): the loss streams at rtol 1e-5 (the port's loss-stream
tolerance, ``tests/test_dist_stream.py``) and every parameter at 1e-4 x
its leaf's max |value| (``gnn_parity.check_three_steps``).  GatedGCN, PNA
and SchNet at ``molecule``, two at ``full_graph``, PNA at ``minibatch``;
EquiformerV2's case is in ``tests/test_torch_equiformer.py``.
"""

import math

import pytest
import torch

import gnn_parity as gp
from repro_torch.configs import registry
from repro_torch.configs.registry import ShapeSpec
from repro_torch.launch import steps


@pytest.mark.parametrize("arch,case", [
    ("gatedgcn", "molecule"), ("pna", "molecule"), ("schnet", "molecule"),
    ("gatedgcn", "full_graph"), ("schnet", "full_graph"),
    ("pna", "minibatch_lg"),
])
def test_three_adamw_steps_match_the_reference_cell(arch, case):
    gp.check_three_steps(arch, case)


def test_train_step_reaches_every_leaf_and_updates_in_place():
    """The last GatedGCN layer's edge norm is not on the loss's path: it
    gets a zero gradient (as under ``jax.grad``) and only weight decay
    moves it; the step writes the same tensors."""
    tcfg = registry.get_arch("gatedgcn").make_smoke_config()
    shape = ShapeSpec("molecule", "molecule", gp.CASES["molecule"])
    params, opt = steps.gnn_train_state(torch.Generator().manual_seed(0),
                                        "gatedgcn", tcfg, 6, 2)
    last = params["layers"][tcfg.n_layers - 1]
    ptr, before = last["A"].data_ptr(), last["A"].detach().clone()
    step = steps.gnn_train_step("gatedgcn", tcfg, "molecule")
    params, opt, loss = step(params, opt, steps.gnn_batches(shape))
    assert last["A"].data_ptr() == ptr
    assert not torch.equal(last["A"].detach(), before)
    name = f"layers.{tcfg.n_layers - 1}.ln_e_b"
    assert float(opt["m"][name].abs().max()) == 0.0
    assert math.isfinite(float(loss)) and not loss.requires_grad
    with pytest.raises(ValueError, match="seed count"):
        steps.gnn_train_step("pna", tcfg, "minibatch")(
            params, opt, steps.gnn_batches(shape))
