"""The port's static-GNN launcher (``python -m repro_torch.launch.train
--arch <gnn arch>``) on the CPU.

Finite losses for each of the four archs; its losses equal to
``launch.steps.gnn_train_step``'s on the reference's smoke batch; the
refusals (dyngnn flags, a grid the ranks do not fill; ``din`` now trains); and,
pinned, the reference launcher's NaN after step 0, which the port's
launcher, from a real init and a real batch, does not share.
"""

import contextlib
import io
import math
import sys

import pytest
import torch

import gnn_parity as gp
from repro.launch import train as jtrain
from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.launch import train as launch_train
from repro_torch.models.gnn import common


@pytest.mark.parametrize("arch", gp.ARCHS)
def test_launcher_trains_each_arch(arch, capsys):
    launch_train.main(["--arch", arch, "--device", "cpu", "--steps", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "done"
    assert [ln.split()[1] for ln in lines[:-1]] == ["0", "1", "2"]
    losses = [float(ln.split()[-1]) for ln in lines[:-1]]
    assert all(math.isfinite(x) for x in losses)


def test_launcher_gnn_matches_the_train_step(capsys):
    """The launcher's losses are ``gnn_train_step``'s on the reference's
    smoke override of ``molecule`` (``batch_molecules(2, 16, 32, 8)``,
    seed 0) from ``init_params`` (generator seed 0) and ``init_state``."""
    launch_train.main(["--arch", "pna", "--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out.splitlines()
    got = [float(ln.split()[-1]) for ln in out if ln.startswith("step")]
    cfg = registry.get_arch("pna").make_smoke_config()
    params, opt = steps.gnn_train_state(torch.Generator().manual_seed(0),
                                        "pna", cfg, 8, 2)
    batch = common.batch_molecules(2, 16, 32, 8, seed=0)
    step = steps.gnn_train_step("pna", cfg, "molecule")
    want = []
    for _ in range(2):
        params, opt, loss = step(params, opt, [batch])
        want.append(round(float(loss), 4))
    assert got == want


def test_launcher_refusals(monkeypatch, capsys):
    with pytest.raises(SystemExit, match="--stream configure the dyngnn"):
        launch_train.main(["--arch", "schnet", "--device", "cpu",
                           "--stream", "--steps", "1"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="does not divide the 2 processes"):
        launch_train.main(["--arch", "pna", "--device", "cpu",
                           "--data-parallel", "3", "--steps", "1"])
    monkeypatch.delenv("WORLD_SIZE")
    capsys.readouterr()
    launch_train.main(["--arch", "din", "--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "done" and len(out) == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_train.main(["--arch", "gatedgcn", "--steps", "1"])


def test_reference_launcher_goes_nan_and_the_port_does_not(monkeypatch,
                                                           capsys):
    """Pinned: the reference's launcher fills every leaf of the cell's
    inputs with N(0, 0.1) draws -- AdamW's second moment too, so
    ``sqrt(v)`` is NaN where a draw is negative -- and its edges and graph
    ids with 0 or 1; step 0 is finite, step 1 NaN.  The port's launcher
    starts from ``init_params``, ``init_state`` and ``batch_molecules``."""
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "gatedgcn",
                                      "--steps", "2"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jtrain.main()
    ref = [ln.split()[-1] for ln in buf.getvalue().splitlines()
           if ln.startswith("step")]
    assert math.isfinite(float(ref[0])) and ref[1] == "nan"
    launch_train.main(["--arch", "gatedgcn", "--device", "cpu",
                       "--steps", "2"])
    port = [float(ln.split()[-1]) for ln in
            capsys.readouterr().out.splitlines() if ln.startswith("step")]
    assert len(port) == 2 and all(math.isfinite(x) for x in port)
