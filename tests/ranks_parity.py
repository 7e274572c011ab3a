"""Shared checks of the cells-over-ranks tests (``test_torch_gnn_ranks.py``,
``test_torch_din_ranks.py``, ``test_torch_grid_specs.py``): the
reference's ``PartitionSpec`` trees against a cell's spec tuples, and a
gathered train step against the reference's.  Imports JAX: the ranks'
own module is ``tests/gnn_din_ranks.py``.

Tolerances (``tests/test_torch_lm_ranks.py``'s): the loss rtol 1e-5;
parameters, ``m`` and ``master`` 1e-5 (abs and rel); ``v`` (~g^2) 1e-4 x
each leaf's max, or twice the port's own one-process distance from the
reference where that is larger (``check_train``).
"""

import jax
import numpy as np
from jax.sharding import AbstractMesh

from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro_torch.dist import sharding as shd
from repro_torch.launch import steps

TOL = 1e-5
V_TOL = 1e-4
GRIDS = ((1, 1), (1, 2), (2, 2), (1, 4), (4, 1), (16, 16))
CAPACITY = 85_017_493_504


def norm(p) -> tuple:
    """A reference ``PartitionSpec`` as the port writes a spec."""
    return tuple(None if e is None else ((e,) if isinstance(e, str)
                                         else tuple(e)) for e in p)


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", k)))


def ref_specs(tree) -> dict:
    """{path: spec} of a tree of ``NamedSharding``s (lists by index)."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
    return {".".join(_key(k) for k in path): norm(v.spec)
            for path, v in leaves}


def port_specs(specs) -> dict:
    """{path: spec} of a cell's spec tuple, in the reference's paths (the
    AdamW state's ``m`` / ``v`` / ``master`` keyed by parameter name);
    a single spec (a serve cell's output) at the path ``""``."""
    if all(e is None or isinstance(e, tuple) and all(
            isinstance(a, str) for a in e) for e in specs):
        return {"": specs}
    out = {}
    for i, sp in enumerate(specs):
        if isinstance(sp, dict):
            out.update({f"{i}.{k}": v for k, v in shd.flat_specs(sp).items()})
        else:
            out[str(i)] = sp
    return out


def jmesh(pd: int, pm: int):
    if pd * pm <= len(jax.devices()):
        return jmake_host_mesh(pd, pm)
    return AbstractMesh((pd, pm), ("data", "model"))


def check_specs(arch: str, shape: str, pd: int, pm: int) -> None:
    jcell = jsteps.build_cell(arch, shape, jmesh(pd, pm))
    cell = steps.build_cell(arch, shape, shd.Grid(pd, pm, 0, None, None),
                            device="cpu")
    # the port's m / v / master are keyed by parameter name: the same
    # dotted paths as the reference's trees
    assert port_specs(cell.in_specs) == ref_specs(jcell.in_shardings)
    assert port_specs(cell.out_specs) == ref_specs(jcell.out_shardings)


def flat(tree) -> dict:
    return {".".join(_key(k) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def close(got: dict, want: dict, tol: float, name: str) -> None:
    assert got.keys() == want.keys(), name
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=tol, atol=tol,
                                   err_msg=f"{name} {k}")


def check_train(got: dict, want: dict, name: str, alone: dict) -> None:
    """The gathered train step against the reference's: ``v`` within
    ``V_TOL`` x its leaf's max, or, where the port's one-process step on
    the same global batch (``alone``) is further from the reference
    (PNA's std at a node's near-equal messages: d std / d var is 1 /
    (2 sqrt(var + 1e-5)), 158 at var 0, so the order of the sums moves g
    further), within twice that floor."""
    for loss in got["loss"]:             # every rank: the global loss
        np.testing.assert_allclose(loss, want["loss"], rtol=TOL)
    for k in ("params", "m", "master"):
        close(got[k], want[k], TOL, f"{name} {k}")
    assert got["v"].keys() == want["v"].keys()
    for k, w in want["v"].items():
        floor = 2 * float(np.abs(alone["v"][k] - w).max())
        np.testing.assert_allclose(
            got["v"][k], w, rtol=0,
            atol=max(V_TOL * float(np.abs(w).max()), floor),
            err_msg=f"{name} v {k}")
