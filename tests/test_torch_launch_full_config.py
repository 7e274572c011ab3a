"""``python -m repro_torch.launch.train --full-config`` for the LM and
GNN families: which shape the launcher hands its family's train cell.  In
a file of its own: the launcher ends every process group when it returns,
so it cannot share a module with ``tests/test_torch_cells.py``'s group."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch.launch import steps


@pytest.mark.parametrize("arch,override", [
    ("minicpm-2b", {"seq_len": 128, "global_batch": 2}),
    ("schnet", None)])
def test_full_config_launcher_keeps_an_lm_on_the_smoke_batch(
        monkeypatch, capsys, arch, override):
    """``launch.train --full-config``: an LM still trains on the
    reference's smoke batch of 2 x 128 tokens (``train_4k``'s 256 x 4,096
    would not fit one card at full width); a GNN takes its registry
    shape.  The cell is built at the smoke widths here, so the CPU can
    take the step."""
    from repro_torch.launch import train as launch_train

    seen = {}
    real = steps.build_cell

    def build(arch_id, shape_name, mesh=None, smoke=False, **kw):
        seen.update(smoke=smoke, override=kw.get("shape_override"))
        cell = real(arch_id, shape_name, mesh, smoke=True, **kw)

        def step(params, opt, *batch):
            seen["batch"] = [tuple(b.shape) for b in batch
                             if isinstance(b, torch.Tensor)]
            return cell.step(params, opt, *batch)

        return dataclasses.replace(cell, step=step)

    monkeypatch.setattr(steps, "build_cell", build)
    launch_train.main(["--arch", arch, "--device", "cpu", "--full-config",
                       "--steps", "1"])
    assert seen["smoke"] is False and seen["override"] == override
    if override:
        assert seen["batch"] == [(2, 128), (2, 128)]
    out = capsys.readouterr().out
    assert "step 0 loss" in out and out.rstrip().endswith("done")
