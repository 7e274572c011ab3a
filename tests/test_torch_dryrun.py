"""``repro_torch.launch.dryrun`` on the CPU, at a capacity given with no
card: the reckoning's argument bytes against the reference cells'
abstract inputs for all 60 cells, the verdicts at the H100's capacity,
``dyngnn_analytic`` against ``repro.launch.dryrun._dyngnn_analytic`` for
the 20 dyngnn cells at 1 and 4 chips, and the CLI."""

from __future__ import annotations

import importlib
import json
import os

import jax
import numpy as np
import pytest
import torch.distributed as dist

from repro.configs import registry as jregistry
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro_torch.launch import dryrun, mesh, steps

#: the H100 80GB HBM3's ``total_memory`` (bytes), as the card reports it
H100_BYTES = 85_017_493_504

CELLS = steps.all_cells()
DYNGNN = [c for c in CELLS if
          jregistry.get_arch(c[0]).family == "dyngnn"]


@pytest.fixture(scope="module")
def grid():
    opened = not dist.is_initialized()
    g = mesh.join_one_rank("cpu")
    yield g
    if opened:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dry-run module.  It sets ``XLA_FLAGS`` to 512 host
    devices as it is imported, so the backend is started first (with the
    test session's devices) and the variable is put back after."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


@pytest.fixture(scope="module")
def records(grid):
    return {(r["arch"], r["shape"]): r
            for r in dryrun.dry_run(CELLS, H100_BYTES, device="cpu",
                                    log=lambda _: None)}


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_argument_bytes_are_the_reference_cells(records, arch, shape):
    ref = jsteps.build_cell(arch, shape, jmake_host_mesh(1, 1))
    want = sum(int(np.prod(a.shape)) * a.dtype.itemsize
               for a in jax.tree.leaves(ref.abstract_inputs))
    rec = records[(arch, shape)]
    assert rec["arg_bytes"] == want
    assert rec["capacity_bytes"] == H100_BYTES
    assert rec["need_bytes"] == (want + sum(rec["work"].values())
                                 + dryrun.RESERVE)
    assert rec["fits"] == (rec["need_bytes"] <= H100_BYTES)


def test_the_verdicts_on_one_h100(records):
    fits = {k for k, r in records.items() if r["fits"]}
    lm = [k for k in records if k[0] in ("yi-6b", "gemma-7b", "minicpm-2b",
                                         "olmoe-1b-7b",
                                         "moonshot-v1-16b-a3b")]
    # of the LM cells only the two long_500k decodes whose caches fit
    assert {k for k in lm if k in fits} == {("yi-6b", "long_500k"),
                                            ("olmoe-1b-7b", "long_500k")}
    assert records[("yi-6b", "long_500k")]["arg_bytes"] == 46_481_809_416
    assert records[("yi-6b", "decode_32k")]["arg_bytes"] > 274.9e9
    gnn = {k for k in records if k[0] in ("gatedgcn", "pna", "schnet",
                                          "equiformer-v2")}
    assert gnn - fits == {(a, "ogb_products") for a in (
        "gatedgcn", "pna", "schnet", "equiformer-v2")} | {
        ("equiformer-v2", "minibatch_lg")}
    assert {k for k in records if k[0] == "din"} <= fits
    # the paper's cells: the reckoning, not a list, decides; TM-GCN fits
    # at epinions' full T = 512 and no model fits at youtube's
    assert ("tmgcn", "dtdg_epinions") in fits
    assert not any(k in fits for k in DYNGNN if k[1] == "dtdg_youtube")
    for k in DYNGNN:
        assert records[k]["fits"] == records[("tmgcn" if k[0] ==
                                              "paper_dyngnn" else k[0],
                                              k[1])]["fits"]
    # the dyngnn cells chip_smoke.py's cells group steps (CELLS_STEPPED)
    assert {k for k in DYNGNN if k in fits and k[0] != "paper_dyngnn"} == {
        ("tmgcn", "dtdg_epinions"), ("tmgcn", "dtdg_flickr"),
        ("tmgcn", "dtdg_amlsim"), ("tmgcn", "dtdg_weak_scale"),
        ("cdgcn", "dtdg_weak_scale"),
        ("evolvegcn", "dtdg_epinions"), ("evolvegcn", "dtdg_flickr"),
        ("evolvegcn", "dtdg_amlsim"), ("evolvegcn", "dtdg_weak_scale")}
    assert len(fits) == 30


@pytest.mark.parametrize("chips", [1, 4])
@pytest.mark.parametrize("arch,shape", DYNGNN,
                         ids=[f"{a}-{s}" for a, s in DYNGNN])
def test_dyngnn_analytic_is_the_references(grid, jdryrun, arch, shape,
                                           chips):
    ref = jsteps.build_cell(arch, shape, jmake_host_mesh(1, 1))
    jcfg = jregistry.get_arch(arch).make_config()
    want_cost, want_coll = jdryrun._dyngnn_analytic(ref, jcfg, chips)
    cell = steps.build_cell(arch, shape, grid, device="cpu")
    cost, coll = dryrun.dyngnn_analytic(cell.meta, cell.config, chips)
    assert cost == want_cost and coll == want_coll
    rl = dryrun.roofline(cost, coll)
    assert rl["bound_s"] == max(cost["flops"] / dryrun.PEAK_FP32,
                                cost["bytes accessed"] / dryrun.HBM_BW,
                                coll["total"] / dryrun.NVLINK_BW)


def test_cli_writes_a_record_a_cell_and_refuses_run_without_a_card(
        tmp_path, capsys):
    dryrun.main(["--arch", "yi-6b", "--shape", "long_500k", "--device",
                 "cpu", "--capacity", str(H100_BYTES), "--out",
                 str(tmp_path)])
    rec = json.loads((tmp_path / "yi-6b__long_500k.json").read_text())
    assert rec["fits"] and rec["arg_bytes"] == 46_481_809_416
    assert capsys.readouterr().out.startswith("yi-6b x long_500k: fits")
    with pytest.raises(SystemExit, match="--capacity"):
        dryrun.main(["--all", "--device", "cpu", "--run", "--capacity",
                     "1"])
    with pytest.raises(SystemExit, match="--all"):
        dryrun.main(["--arch", "yi-6b"])
