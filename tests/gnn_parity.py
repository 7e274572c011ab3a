"""Shared helpers of the static-GNN parity tests (``test_torch_gnn*.py``,
``test_torch_equiformer.py``): small shapes, batches given to both
packages, the reference cell's loss, and the two checks every arch runs
(logits and gradients; three AdamW steps beside the reference cell)."""

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import registry as jregistry
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.models.gnn import common as jcommon
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.registry import ShapeSpec
from repro_torch.launch import steps
from repro_torch.models.gnn.common import GraphBatch

ARCHS = ("gatedgcn", "pna", "schnet", "equiformer-v2")

SHAPES = {
    "molecule": ShapeSpec("molecule", "molecule",
                          {"n_nodes": 8, "n_edges": 16, "batch": 3,
                           "d_feat": 6, "num_classes": 2}),
    # 60 edges in 128 lanes: 68 padding lanes, masked
    "full_graph": ShapeSpec("full_graph", "full_graph",
                            {"n_nodes": 24, "n_edges": 60, "d_feat": 7,
                             "num_classes": 3}),
    # 4 seeds, fanouts 3 then 2: 36 edges, 40 nodes
    "minibatch": ShapeSpec("minibatch", "minibatch",
                           {"n_nodes": 1000, "n_edges": 9000,
                            "batch_nodes": 4, "fanouts": (3, 2),
                            "d_feat": 7, "num_classes": 3}),
}


def configs(arch: str):
    return (jregistry.get_arch(arch).make_smoke_config(),
            registry.get_arch(arch).make_smoke_config())


def arrays(shape: ShapeSpec, replicas: int = 1, seed: int = 0,
           masked=(5,)) -> list[dict]:
    """The port's batch arrays with the edges ``masked`` masked too."""
    out = steps.gnn_batch_arrays(shape, replicas, seed)
    for a in out:
        a["edge_mask"][list(masked)] = 0.0
    return out


def jax_batch(a: dict, num_graphs: int = 1) -> jcommon.GraphBatch:
    return jcommon.GraphBatch(num_graphs=num_graphs, **{
        k: None if v is None else jnp.asarray(v) for k, v in a.items()})


def torch_batch(a: dict, num_graphs: int = 1) -> GraphBatch:
    return GraphBatch.from_arrays(a, num_graphs)


def jax_params(arch: str, jcfg, shape: ShapeSpec):
    """The reference cell's init (``_gnn_init_fn``, key 0)."""
    d = shape.dims
    return jsteps._gnn_init_fn(arch, jcfg, d["d_feat"], d["num_classes"])()


def jax_cell_loss(fwd, kind: str, seeds: int):
    """The loss of ``_gnn_full_graph_cell`` / one replica of
    ``_gnn_replica_cell``, for one batch."""
    def loss(p, b):
        out = fwd(p, b)
        if kind == "molecule":
            val = jcommon.node_ce_loss(out, b.labels,
                                       jnp.ones((b.num_graphs,)))
        elif kind == "minibatch":
            val = jcommon.node_ce_loss(out[:seeds], b.labels[:seeds],
                                       b.node_mask[:seeds])
        else:
            val = jcommon.node_ce_loss(out, b.labels, b.node_mask)
        return val, out
    return loss


def x64():
    """JAX's float64 scope (``jax.enable_x64`` since 0.4.38, before that
    ``jax.experimental.enable_x64``)."""
    if callable(getattr(jax, "enable_x64", None)):
        return jax.enable_x64(True)
    from jax.experimental import enable_x64
    return enable_x64()


def jax_grads64(loss, jparams, a: dict, num_graphs: int) -> dict:
    """``jax.grad`` of ``loss`` in float64: the parameters and the float
    inputs widened (the reference's own f32 casts, in its loss and its
    SO(3) tables, stay), as a flat dict of numpy arrays."""
    with x64():
        p64 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64)),
                           jparams)
        b64 = jax_batch({k: None if v is None else
                         v.astype(np.float64) if v.dtype == np.float32
                         else v for k, v in a.items()}, num_graphs)
        grads = jax.jit(jax.grad(lambda p, b: loss(p, b)[0]))(p64, b64)
        return flat(grads)


def flat(tree) -> dict:
    """A JAX tree -> {``ParamTree`` name: numpy array}."""
    def name(path):
        return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
    return {name(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_params(jparams):
    return convert.params_from_jax(jax.tree.map(np.asarray, jparams))


def check_arch(arch: str, kind: str, tol: float) -> None:
    """Logits and the cell loss (f32) and the loss's gradients (against
    the reference's in float64), port against reference, at ``tol``."""
    jcfg, tcfg = configs(arch)
    shape = SHAPES[kind]
    dims = steps.gnn_dims(shape)
    graphs = dims["seeds"] if kind == "molecule" else 1
    (a,) = arrays(shape)
    jparams = jax_params(arch, jcfg, shape)
    jloss = jax_cell_loss(jsteps._gnn_forward_fn(arch, jcfg), kind,
                          dims["seeds"])
    want_loss, want = jax.jit(jloss)(jparams, jax_batch(a, graphs))
    params = port_params(jparams)
    batch = torch_batch(a, graphs)
    fwd = steps.gnn_logits_fn(arch, tcfg)
    got = fwd(params, batch)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)
    loss, grads = steps.gnn_loss_and_grads(fwd, kind, params, [batch],
                                           dims["seeds"])
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=tol,
                               atol=tol)
    names = [n for n, _ in params.named_parameters()]
    want_g = jax_grads64(jloss, jparams, a, graphs)
    assert sorted(names) == sorted(want_g)
    for name, g in zip(names, grads, strict=True):
        w = want_g[name]
        assert w.dtype == np.float64, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=tol * max(float(np.abs(w).max()),
                                                  1e-30), err_msg=name)


R = 2                          # replicas of the data=2 host mesh

#: shape overrides of the train-step checks
CASES = {
    "molecule": {"n_nodes": 8, "n_edges": 16, "batch": 4, "d_feat": 6,
                 "num_classes": 2},
    # 200 edges: 256 lanes for one device's 128-rounding and the data=2
    # mesh's 256 alike, 56 of them padding
    "full_graph": {"n_nodes": 24, "n_edges": 200, "d_feat": 7,
                   "num_classes": 3},
    "minibatch_lg": {"batch_nodes": 8, "fanouts": (3, 2), "d_feat": 7,
                     "num_classes": 3},
}
SHAPE_OF = {"molecule": "molecule", "full_graph": "full_graph_sm",
            "minibatch_lg": "minibatch_lg"}


def _jax_args(kind: str, arrs: list, dims: dict) -> tuple:
    """The cell's concrete inputs after (params, opt_state)."""
    if kind == "full_graph":
        (a,) = arrs
        return tuple(jnp.asarray(a[k]) for k in (
            "edges", "edge_mask", "node_feat", "positions", "labels",
            "node_mask"))

    def stack(k):
        return jnp.asarray(np.stack([a[k] for a in arrs]))

    gid = (stack("graph_id") if kind == "molecule" else
           jnp.zeros((R, dims["nodes"]), jnp.int32))
    return tuple(stack(k) for k in (
        "edges", "edge_mask", "node_feat", "positions", "labels",
        "node_mask")) + (gid,)


def check_three_steps(arch: str, case: str) -> None:
    """Three AdamW steps of ``gnn_train_step`` beside the reference
    cell's ``step`` on the data=2 host mesh, from one state and batch:
    losses at rtol 1e-5, parameters at 1e-4 x each leaf's max."""
    mesh = make_host_mesh(data=R, model=1)
    cell = jsteps.build_cell(arch, SHAPE_OF[case], mesh, smoke=True,
                             shape_override=CASES[case])
    base = registry.get_arch(arch).shapes[SHAPE_OF[case]]
    shape = ShapeSpec(base.name, base.kind, {**base.dims, **CASES[case]})
    kind = shape.kind
    replicas = 1 if kind == "full_graph" else R
    dims = steps.gnn_dims(shape, replicas)
    if kind == "full_graph":
        assert (dims["nodes"], dims["edges"]) == (cell.meta["nodes"],
                                                  cell.meta["edges"])
    else:
        assert (dims["nodes"], dims["edges"]) == (
            cell.meta["nodes_per_replica"], cell.meta["edges_per_replica"])
    arrs = arrays(shape, replicas, seed=7, masked=(3,))
    jcfg, tcfg = configs(arch)
    jparams = jax_params(arch, jcfg, shape)
    jopt = jadamw.init_state(jparams)
    params = port_params(jparams)
    opt = convert.opt_state_from_jax(jax.tree.map(np.asarray, jopt))
    graphs = dims["seeds"] if kind == "molecule" else 1
    batches = [torch_batch(a, graphs) for a in arrs]
    step = steps.gnn_train_step(arch, tcfg, kind, seeds=dims["seeds"])
    args = _jax_args(kind, arrs, dims)
    want, got = [], []
    with mesh:
        jstep = jax.jit(cell.step, in_shardings=cell.in_shardings,
                        out_shardings=cell.out_shardings)
        for _ in range(3):
            jparams, jopt, jl = jstep(jparams, jopt, *args)
            params, opt, loss = step(params, opt, batches)
            want.append(float(jl))
            got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert int(opt["step"]) == int(jopt["step"]) == 3
    want_p = flat(jparams)
    for name, p in params.named_parameters():
        w = want_p[name]
        np.testing.assert_allclose(
            p.detach().numpy(), w, rtol=0,
            atol=1e-4 * float(np.abs(w).max()), err_msg=name)
