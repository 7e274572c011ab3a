"""The GNN, DIN and dyngnn cells' layouts over grids and their per-rank
reckoning (``launch.dryrun --grid``), held to the JAX package on the CPU.

* The spec trees: every ``in_specs`` / ``out_specs`` leaf equals the
  reference's ``in_shardings`` / ``out_shardings`` ``PartitionSpec``: the
  four GNN archs' cells at their four shapes and DIN's four on host
  meshes of 1 x 1, 1 x 2, 2 x 2, 1 x 4 and 4 x 1 and on a 16 x 16
  stand-in (a ``jax.sharding.AbstractMesh``) -- a full graph's edges
  ``P(dp, None)``, EquiformerV2's node rows ``P(dp)``, a replica cell's
  leaves ``P(dp, ...)``, DIN's tables ``P(model, None)`` when the model
  axis is wider than 1, its rows over data when ``batch >= dp``, its
  candidates over data; the dyngnn cells' (``P(None, dp)`` on a rank's
  steps of each block, ``P(None, None, dp)`` on its vertices' labels
  under the fused loss) at 2 x 2, 4 x 1 and 16 x 16.
* A rank's argument bytes from the specs equal the bytes of the
  reference's shard shapes (``NamedSharding.shard_shape`` of each abstract
  input under its ``in_shardings``) for every GNN, DIN and dyngnn cell at
  2 x 2 (DIN's at 1 x 4 too).
* The smallest grids of H100 80GB cards of the 12 GNN and dyngnn cells
  one card cannot hold (``PERF.md`` section 7).
"""

import jax
import numpy as np
import pytest

from ranks_parity import CAPACITY, GRIDS, check_specs
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro_torch.dist import sharding as shd
from repro_torch.launch import steps

ARCHS = ("gatedgcn", "pna", "schnet", "equiformer-v2")
SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
DIN_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
DYNGNN = ("tmgcn", "cdgcn", "evolvegcn", "paper_dyngnn")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("pd,pm", GRIDS)
def test_spec_trees_equal_the_reference(arch, shape, pd, pm):
    check_specs(arch, shape, pd, pm)


@pytest.mark.parametrize("shape", DIN_SHAPES)
@pytest.mark.parametrize("pd,pm", GRIDS)
def test_din_spec_trees_equal_the_reference(shape, pd, pm):
    check_specs("din", shape, pd, pm)


@pytest.mark.parametrize("arch", ("tmgcn", "cdgcn", "evolvegcn"))
@pytest.mark.parametrize("shape", ("dtdg_youtube", "dtdg_weak_scale"))
@pytest.mark.parametrize("pd,pm", ((2, 2), (4, 1), (16, 16)))
def test_dyngnn_spec_trees_equal_the_reference(arch, shape, pd, pm):
    check_specs(arch, shape, pd, pm)


GNN_CELLS = [(a, s) for a, s in steps.all_cells()
             if a in ARCHS or a in DYNGNN]


@pytest.mark.parametrize("arch,shape", GNN_CELLS)
def test_rank_bytes_are_the_reference_shard_shapes(arch, shape):
    check_rank_bytes(arch, shape, 2, 2)


@pytest.mark.parametrize("shape", DIN_SHAPES)
@pytest.mark.parametrize("pd,pm", ((2, 2), (1, 4)))
def test_din_rank_bytes_are_the_reference_shard_shapes(shape, pd, pm):
    check_rank_bytes("din", shape, pd, pm)


def check_rank_bytes(arch: str, shape: str, pd: int, pm: int) -> None:
    """``launch.dryrun``'s per-rank argument bytes on a ``pd x pm`` grid
    equal the bytes of the reference's shard shapes."""
    from repro_torch.launch import dryrun
    ref = jsteps.build_cell(arch, shape, jmake_host_mesh(pd, pm))
    want = 0
    for a, sh in zip(jax.tree.leaves(ref.abstract_inputs),
                     jax.tree.leaves(ref.in_shardings), strict=True):
        want += int(np.prod(sh.shard_shape(a.shape))) * a.dtype.itemsize
    cell = dryrun.grid_cell(arch, shape, pd, pm, device="cpu")
    rec = dryrun.reckon(cell, CAPACITY, shd.Grid(pd, pm, 0, None, None))
    assert rec["arg_bytes"] == want
    assert rec["grid"] == [pd, pm]


def test_the_smallest_grids_of_the_cells_one_h100_cannot_hold():
    """The 12 GNN and dyngnn cells one H100 80GB cannot hold, and the
    smallest grid of them that holds each (``launch.dryrun --grid``;
    PERF.md section 4): the model axis holds copies, so D x 1.
    EquiformerV2's ``ogb_products`` has none: each layer gathers the
    normed irreps of all 2,449,030 rows (61 GB) and sums its lanes'
    messages into as many before the reduce-scatter, on every rank."""
    from repro_torch.launch import dryrun
    recs = dryrun.grid_run(GNN_CELLS, 2, 2, CAPACITY, "cpu",
                           log=lambda _m: None)
    got = {(r["one_card"]["arch"], r["one_card"]["shape"]):
           r["smallest"] and tuple(r["smallest"]["grid"])
           for r in recs if "smallest" in r}
    assert got == {
        ("gatedgcn", "ogb_products"): (8, 1),
        ("pna", "ogb_products"): (2, 1),
        ("schnet", "ogb_products"): (4, 1),
        ("equiformer-v2", "ogb_products"): None,
        ("equiformer-v2", "minibatch_lg"): (2, 1),
        ("tmgcn", "dtdg_youtube"): (2, 1),
        ("cdgcn", "dtdg_epinions"): (2, 1),
        ("cdgcn", "dtdg_flickr"): (2, 1),
        ("cdgcn", "dtdg_youtube"): (4, 1),
        ("cdgcn", "dtdg_amlsim"): (2, 1),
        ("evolvegcn", "dtdg_youtube"): (2, 1),
        ("paper_dyngnn", "dtdg_youtube"): (2, 1)}
    for r in recs:
        if r.get("smallest"):
            assert r["smallest"]["fits"] and not r["one_card"]["fits"]
        elif "smallest" not in r:
            assert r["one_card"]["fits"]
