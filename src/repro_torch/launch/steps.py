"""Step builders and abstract inputs for every (arch x shape) cell.

Port of ``repro.launch.steps``.  ``build_cell(arch_id, shape_name, mesh)``
returns a :class:`Cell`: its ``step``, its ``abstract_inputs`` (meta
tensors with the reference's leaf paths, shapes and dtypes: no memory, no
numbers) and ``make_inputs(seed, device)``, concrete inputs the step
accepts.  Train cells take a FULL training step (loss, gradients by
autograd, the repo's AdamW, ``repro_torch.optim.adamw``); decode, prefill
and recsys-serve cells take a serve step.  :func:`all_cells` names the
reference's 60 (arch x shape) pairs in its order.

The per-family steps the cells dispatch to:

* :func:`lm_train_step` is ``_lm_train_cell``'s ``train_step`` --
  ``lm_loss`` and its gradients, then AdamW on the LM tree held as a
  ``core.models.ParamTree``; the prefill and decode cells call
  ``models.lm.prefill`` and ``decode_step`` (the KV cache written in
  place);
* :func:`gnn_train_step` is the ``train_step`` of ``_gnn_full_graph_cell``
  and ``_gnn_replica_cell`` for the four static GNNs: the node loss over
  ``node_mask`` (``full_graph``), over the first ``seeds`` rows
  (``minibatch``) or per graph (``molecule``), averaged over the replica
  batches (the reference's ``vmap`` then ``mean``), then AdamW
  (``AdamWConfig()``, as there).  :func:`gnn_batches` builds concrete
  batches at a shape's dims;
* the steps of ``_din_cell``: :func:`din_train_step` (``ctr_loss`` and
  its gradients, then AdamW with ``AdamWConfig()``), :func:`din_serve_step`
  (``forward``) and :func:`din_retrieval_step` (``score_candidates``, in
  chunks of :data:`RETRIEVAL_CHUNK` on one card where the reference
  splits the candidates over its data-parallel devices); :func:`din_batch`
  builds a concrete batch at a recsys shape's dims;
* the dyngnn cell (``_dyngnn_cell``) is the snapshot-partitioned,
  checkpointed train step over the grid's data group:
  ``partition.snapshot_partition_loss`` with bf16 all-to-all payloads and
  the final layer's loss fused in the vertex-sharded domain, one gradient
  ``all_reduce`` a leaf, then ``AdamWConfig()``
  (``train.trainer.make_dyngnn_train_step``).  ``paper_dyngnn`` is
  ``tmgcn``'s config.

A mesh is a ``dist.sharding.Grid`` (``launch.mesh.make_host_mesh``).  Every
cell runs over any ``data x model`` grid whose shape divides as the
reference's specs require (refused otherwise, as the reference's sharding
refuses it): its layouts are the reference's spec functions, ported
(:func:`lm_param_specs`, :func:`_lm_head_specs`, :func:`_fsdp_opt_specs`,
:func:`_chunk_constrainer`, :func:`_lm_kv_specs`, :func:`_din_batch_specs`,
``dist.sharding.din_param_specs`` / ``replicate_specs`` /
``opt_state_specs``); ``in_specs`` / ``out_specs`` are the counterparts
of the reference's ``in_shardings`` / ``out_shardings``, ``make_inputs``
gives this rank's share of the 1 x 1 ``make_inputs`` (an LM's drawn leaf
by leaf and sliced, the KV cache a layer at a time; a replica GNN cell's
one replica; so no rank holds the whole tree where it is large), and the
step computes this rank's part of the reference's jitted cell on the
global batch: ``models.lm.Layout`` and ``optim.adamw.Zero`` for the LMs;
the static GNNs' full graph split by edge lanes over data with node rows
a rank's (``models.gnn.common.GraphLayout``) and their replica cells one
replica a data rank, the gradients summed over data only; DIN's tables
split by vocab over model (``models.din.Layout``) and its rows or
candidates over data; the dyngnn cell's snapshot partitioning over the
data column.  At 1 x 1 (or ``None``: no process group, the LM, GNN and
recsys cells) a cell is its one-rank step, bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.configs.registry import ShapeSpec
from repro_torch.core import models as dyn_models
from repro_torch.core.models import ParamTree
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import Grid, ShardLayout, spec
from repro_torch.graph import segment
from repro_torch.models import din, lm
from repro_torch.models.gnn import (common, equiformer_v2, gatedgcn, pna,
                                    schnet)
from repro_torch.optim import adamw


def lm_tree(params: nn.Module) -> dict:
    """A ``ParamTree`` of the LM tree -> the nested dict of its parameters
    that ``repro_torch.models.lm`` takes (the same tensors, no copy)."""
    tree = {k: lm_tree(m) for k, m in params.named_children()}
    tree.update(params.named_parameters(recurse=False))
    return tree


def lm_train_state(gen: torch.Generator, cfg: lm.LMConfig
                   ) -> tuple[ParamTree, dict]:
    """Fresh parameters from ``gen`` (``init_lm_params``) as a
    ``ParamTree`` and their AdamW state (``adamw.init_state``: zero
    moments, fp32 master copies)."""
    params = ParamTree(lm.init_lm_params(gen, cfg))
    return params, adamw.init_state(params)


def lm_loss_and_grads(cfg: lm.LMConfig, params: nn.Module,
                      tokens: torch.Tensor, targets: torch.Tensor,
                      layout: lm.Layout | None = None
                      ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """``lm_loss`` of the ``ParamTree`` ``params`` and its gradients, in
    ``params.named_parameters()`` order (over a grid: this rank's part of
    the loss and its shards' gradients from its rows)."""
    loss = lm.lm_loss(cfg, lm_tree(params), tokens, targets, layout)
    return loss.detach(), torch.autograd.grad(loss, list(params.parameters()))


def lm_train_step(cfg: lm.LMConfig, opt_cfg: adamw.AdamWConfig | None = None,
                  layout: lm.Layout | None = None,
                  zero: adamw.Zero | None = None) -> Callable:
    """-> ``step(params, opt_state, tokens, targets) -> (params, opt_state,
    loss)``: one AdamW step on ``lm_loss`` (tokens and targets (B, S)).
    ``params`` is updated in place and returned; ``opt_cfg`` defaults to
    the reference's ``AdamWConfig(schedule=cfg.lr_schedule)``.  Over a
    grid (``layout``, ``zero``) the inputs are this rank's shards and rows
    and the loss is the global one (summed over the data column)."""
    opt_cfg = opt_cfg or adamw.AdamWConfig(schedule=cfg.lr_schedule)

    def train_step(params: ParamTree, opt_state: dict, tokens: torch.Tensor,
                   targets: torch.Tensor):
        loss, grads = lm_loss_and_grads(cfg, params, tokens, targets,
                                        layout)
        params, opt_state = adamw.apply_updates(opt_cfg, params, grads,
                                                opt_state, zero)
        if layout is not None:
            loss = shd.all_reduce(loss, layout.data, "dp")
        return params, opt_state, loss

    return train_step


# ------------------------------------------------------------- GNN -----

def gnn_logits_fn(arch_id: str, cfg) -> Callable:
    """-> ``logits(params, batch, layout=None)`` of the arch at ``cfg``
    (``layout``: a ``common.GraphLayout``, a rank's part of a full
    graph)."""
    if arch_id == "gatedgcn":
        return gatedgcn.logits
    if arch_id == "pna":
        return pna.logits
    if arch_id == "schnet":
        return lambda p, b, layout=None: schnet.logits(p, b, cfg.cutoff,
                                                       layout)
    if arch_id == "equiformer-v2":
        return lambda p, b, layout=None: equiformer_v2.logits(
            p, b, layout, l_max=cfg.l_max, m_max=cfg.m_max,
            n_heads=cfg.n_heads, n_rbf=cfg.n_rbf, cutoff=cfg.cutoff)
    raise KeyError(arch_id)


def gnn_init_params(gen: torch.Generator, arch_id: str, cfg, d_in: int,
                    num_classes: int) -> dict:
    """The arch's fresh parameter tree (nested dicts), drawn from ``gen``
    on its device."""
    if arch_id == "gatedgcn":
        return gatedgcn.init_params(gen, d_in, cfg.d_hidden, cfg.n_layers,
                                    num_classes)
    if arch_id == "pna":
        return pna.init_params(gen, d_in, cfg.d_hidden, cfg.n_layers,
                               num_classes)
    if arch_id == "schnet":
        return schnet.init_params(gen, d_in, cfg.d_hidden,
                                  cfg.n_interactions, cfg.n_rbf,
                                  num_classes)
    if arch_id == "equiformer-v2":
        return equiformer_v2.init_params(
            gen, d_in, cfg.d_hidden, cfg.n_layers, cfg.l_max, cfg.m_max,
            cfg.n_heads, cfg.n_rbf, num_classes)
    raise KeyError(arch_id)


def gnn_train_state(gen: torch.Generator, arch_id: str, cfg, d_in: int,
                    num_classes: int) -> tuple[ParamTree, dict]:
    """Fresh parameters as a ``ParamTree`` and their AdamW state."""
    params = ParamTree(gnn_init_params(gen, arch_id, cfg, d_in,
                                       num_classes))
    return params, adamw.init_state(params)


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def gnn_dims(shape: ShapeSpec, replicas: int = 1) -> dict:
    """A cell's per-replica sizes, as the reference's cells compute them:
    ``nodes``, ``edges`` (lanes, padding included), ``seeds`` (minibatch
    seed rows / molecule graphs; 0 for a full graph), ``d_in`` and
    ``num_classes``."""
    d = shape.dims
    out = {"d_in": d["d_feat"], "num_classes": d["num_classes"]}
    if shape.kind == "full_graph":
        return dict(out, nodes=_round_up(d["n_nodes"], replicas),
                    edges=_round_up(d["n_edges"], replicas * 128), seeds=0)
    if shape.kind == "minibatch":
        seeds = max(d["batch_nodes"] // replicas, 1)
        e_sub, cap = 0, seeds
        for f in d["fanouts"]:
            cap *= f
            e_sub += cap
        return dict(out, nodes=seeds + e_sub, edges=e_sub, seeds=seeds)
    if shape.kind == "molecule":
        graphs = max(d["batch"] // replicas, 1)
        return dict(out, nodes=graphs * d["n_nodes"],
                    edges=graphs * d["n_edges"], seeds=graphs)
    raise KeyError(shape.kind)


def gnn_replica_arrays(shape: ShapeSpec, replicas: int = 1, seed: int = 0,
                       replica: int = 0) -> dict:
    """Replica ``replica``'s inputs of a cell over ``replicas`` data ranks
    (for a full graph, its one graph), as numpy arrays: the
    ``GraphBatch`` fields, drawn from ``default_rng(seed + replica)``:

    * ``molecule``: the reference's ``batch_molecules`` (graphs of the
      shape's nodes and edges, no self-loops, positions in [0, 5)^3);
    * ``full_graph``: ``n_edges`` random (src, dst) pairs among the
      ``n_nodes`` nodes without self-loops, the edge lanes rounded up to
      ``replicas x 128`` and the node rows to ``replicas`` as the cell
      rounds them, each padding lane (0, 1) with mask 0 and each padding
      row zero with ``node_mask`` 0 (the real rows and lanes the same at
      every ``replicas``); labels in [0, num_classes);
    * ``minibatch``: the sampled tree of the cell's dims -- ``seeds`` seed
      rows first, then each hop's ``fanout`` children of every node of the
      hop before, one edge child -> parent each; labels on every row (the
      loss reads the seed rows).

    Features are N(0, 1) and positions uniform in [0, 5)^3 for every arch
    (the cells take them whether or not the arch reads them)."""
    dims = gnn_dims(shape, replicas)
    d = shape.dims
    if shape.kind == "molecule":
        return common.molecule_arrays(dims["seeds"], d["n_nodes"],
                                      d["n_edges"], d["d_feat"],
                                      seed=seed + replica)
    rng = np.random.default_rng(seed + replica)
    n, e = dims["nodes"], dims["edges"]
    real_n = n
    if shape.kind == "full_graph":
        real, real_n = d["n_edges"], d["n_nodes"]
        src = rng.integers(0, real_n, size=real)
        dst = (src + rng.integers(1, real_n, size=real)) % real_n
        edges = np.zeros((e, 2), np.int32)
        edges[:, 1] = 1
        edges[:real] = np.stack([src, dst], axis=1)
        emask = np.zeros((e,), np.float32)
        emask[:real] = 1.0
    else:
        edges, lo, width = [], 0, dims["seeds"]
        for f in d["fanouts"]:
            child = lo + width + np.arange(width * f)
            parent = lo + np.arange(width * f) // f
            edges.append(np.stack([child, parent], axis=1))
            lo, width = lo + width, width * f
        edges = np.concatenate(edges).astype(np.int32)
        emask = np.ones((e,), np.float32)

    def rows(a: np.ndarray) -> np.ndarray:
        out = np.zeros((n,) + a.shape[1:], a.dtype)
        out[:real_n] = a
        return out

    nmask = np.zeros((n,), np.float32)
    nmask[:real_n] = 1.0
    return {
        "edges": edges, "edge_mask": emask,
        "node_feat": rows(rng.normal(size=(real_n, d["d_feat"])).astype(
            np.float32)),
        "node_mask": nmask,
        "positions": rows(rng.uniform(0, 5, size=(real_n, 3)).astype(
            np.float32)),
        "graph_id": None,
        "labels": rows(rng.integers(0, d["num_classes"], size=(real_n,))
                       .astype(np.int32))}


def gnn_batch_arrays(shape: ShapeSpec, replicas: int = 1, seed: int = 0
                     ) -> list[dict]:
    """Every replica's :func:`gnn_replica_arrays` (a full graph's one
    graph, rounded for ``replicas`` data ranks)."""
    count = 1 if shape.kind == "full_graph" else replicas
    return [gnn_replica_arrays(shape, replicas, seed, r)
            for r in range(count)]


def gnn_batches(shape: ShapeSpec, replicas: int = 1, seed: int = 0,
                device: str | torch.device = "cpu"
                ) -> list[common.GraphBatch]:
    """:func:`gnn_batch_arrays` as ``GraphBatch``es on ``device``."""
    graphs = gnn_dims(shape, replicas)["seeds"] \
        if shape.kind == "molecule" else 1
    return [common.GraphBatch.from_arrays(a, graphs, device)
            for a in gnn_batch_arrays(shape, replicas, seed)]


def gnn_loss(logits_fn: Callable, kind: str, params,
             batches: Sequence[common.GraphBatch],
             seeds: int | None = None,
             layout: common.GraphLayout | None = None,
             replicas: int | None = None) -> torch.Tensor:
    """The cell's loss: the mean over the replica batches of the node
    loss over ``node_mask`` (``full_graph``), over the first ``seeds`` rows
    (``minibatch``) or the graph-level loss (``molecule``).  Over a grid:
    a full graph's ``layout`` gives this rank's rows' share of it; a
    replica cell's ``replicas`` (the global count) gives these batches'
    share of the mean over all of them."""
    if kind == "minibatch" and not seeds:
        raise ValueError("a minibatch loss needs its seed count")
    losses = []
    for b in batches:
        out = logits_fn(params, b) if layout is None else \
            logits_fn(params, b, layout=layout)
        if kind == "molecule":
            losses.append(common.node_ce_loss(
                out, b.labels, torch.ones_like(out[:, 0])))
        elif kind == "minibatch":
            losses.append(common.node_ce_loss(
                out[:seeds], b.labels[:seeds], b.node_mask[:seeds]))
        elif kind == "full_graph":
            losses.append(common.node_ce_loss(out, b.labels, b.node_mask,
                                              layout))
        else:
            raise KeyError(kind)
    if replicas is not None:
        return torch.stack(losses).sum() / replicas
    return torch.stack(losses).mean()


def gnn_loss_and_grads(logits_fn: Callable, kind: str, params: ParamTree,
                       batches: Sequence[common.GraphBatch],
                       seeds: int | None = None,
                       layout: common.GraphLayout | None = None,
                       replicas: int | None = None
                       ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """:func:`gnn_loss` and its gradients, in ``params.named_parameters()``
    order.  A parameter the loss does not reach (the last GatedGCN layer's
    edge norm) gets a zero gradient, as under ``jax.grad``."""
    loss = gnn_loss(logits_fn, kind, params, batches, seeds, layout,
                    replicas)
    grads = torch.autograd.grad(loss, list(params.parameters()),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), grads


def gnn_train_step(arch_id: str, cfg, kind: str, *,
                   seeds: int | None = None,
                   opt_cfg: adamw.AdamWConfig | None = None,
                   grid: Grid | None = None) -> Callable:
    """-> ``step(params, opt_state, batches) -> (params, opt_state,
    loss)``: one AdamW step on :func:`gnn_loss` over the replica batches
    (one for a full graph).  ``params`` (a ``ParamTree``) is updated in
    place and returned; ``opt_cfg`` defaults to the reference's
    ``AdamWConfig()``.  Over a ``grid`` of more than one rank the batches
    are this rank's part (a full graph's edge lanes and node rows, or its
    data rank's replica), the gradients are summed over the data column
    (the model row holds copies) and the loss is the global one."""
    logits_fn = gnn_logits_fn(arch_id, cfg)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    if grid is not None and grid.pd * grid.pm == 1:
        grid = None
    zero = None if grid is None else adamw.Zero(grid)

    def train_step(params: ParamTree, opt_state: dict,
                   batches: Sequence[common.GraphBatch]):
        layout = replicas = None
        if grid is not None and kind == "full_graph":
            layout = common.GraphLayout(grid, grid.pd * batches[0]
                                        .node_feat.shape[0])
        elif grid is not None:
            replicas = grid.pd * len(batches)
        loss, grads = gnn_loss_and_grads(logits_fn, kind, params, batches,
                                         seeds, layout, replicas)
        params, opt_state = adamw.apply_updates(opt_cfg, params, grads,
                                                opt_state, zero)
        if grid is not None:
            loss = shd.all_reduce(loss, grid.data, "dp")
        return params, opt_state, loss

    return train_step


# ----------------------------------------------------------- recsys -----

def din_train_state(gen: torch.Generator, cfg: din.DINConfig
                    ) -> tuple[ParamTree, dict]:
    """Fresh DIN parameters from ``gen`` (``din.init_params``) as a
    ``ParamTree`` and their AdamW state (``adamw.init_state``)."""
    params = ParamTree(din.init_params(gen, cfg))
    return params, adamw.init_state(params)


def din_loss_and_grads(params: ParamTree, batch: dict, labels: torch.Tensor,
                       layout: din.Layout | None = None
                       ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """``ctr_loss`` and its gradients, in ``params.named_parameters()``
    order (the tables' gradients dense, as under ``jax.grad``; over a
    grid this rank's rows' share of both)."""
    loss = din.ctr_loss(params, batch, labels, layout)
    return loss.detach(), torch.autograd.grad(loss, list(params.parameters()))


def din_train_step(layout: din.Layout | None = None,
                   zero: adamw.Zero | None = None) -> Callable:
    """-> ``step(params, opt_state, batch, labels) -> (params, opt_state,
    loss)``: one AdamW step on ``ctr_loss`` under the reference's
    ``AdamWConfig()``.  ``params`` (a ``ParamTree``) is updated in place
    and returned.  Over a grid (``layout``, ``zero``: the tables' rows
    this rank's, the gradients summed over the data column) the loss is
    the global one."""
    opt_cfg = adamw.AdamWConfig()

    def train_step(params: ParamTree, opt_state: dict, batch: dict,
                   labels: torch.Tensor):
        loss, grads = din_loss_and_grads(params, batch, labels, layout)
        params, opt_state = adamw.apply_updates(opt_cfg, params, grads,
                                                opt_state, zero)
        if layout is not None:
            loss = shd.all_reduce(loss, layout.grid.data, "dp")
        return params, opt_state, loss

    return train_step


@torch.no_grad()
def din_serve_step(params, batch: dict, layout: din.Layout | None = None
                   ) -> torch.Tensor:
    """The recsys serve cell: ``forward`` -> logits (B, C)."""
    return din.forward(params, batch, layout)


@torch.no_grad()
def din_retrieval_step(params, batch: dict, cand_items: torch.Tensor,
                       cand_cates: torch.Tensor, chunk: int | None = None,
                       layout: din.Layout | None = None) -> torch.Tensor:
    """The retrieval cell: ``score_candidates`` of one user's history
    against (N,) candidates, ``chunk`` at a time -> (N,) scores."""
    return din.score_candidates(params, batch, cand_items, cand_cates,
                                chunk=chunk, layout=layout)


def din_batch_arrays(cfg: din.DINConfig, shape: ShapeSpec, seed: int = 0
                     ) -> dict:
    """Concrete inputs at a recsys ``shape``'s dims as numpy arrays, from
    ``default_rng(seed)``: ``batch`` rows of ``din.synthetic_requests``,
    then each row's history length, uniform in [1, seq_len] (the mask
    keeps its first slots); with ``recsys_train`` ``labels`` in
    [0, num_classes), with ``retrieval`` ``n_candidates`` candidate items
    and categories (``cand_items``, ``cand_cates``)."""
    rng = np.random.default_rng(seed)
    b = shape.dims["batch"]
    out = din.synthetic_requests(rng, cfg, b)
    lengths = rng.integers(1, cfg.seq_len + 1, (b,))
    out["hist_mask"] = (np.arange(cfg.seq_len)[None, :]
                        < lengths[:, None]).astype(np.float32)
    if shape.kind == "recsys_train":
        out["labels"] = rng.integers(0, cfg.num_classes, (b,)).astype(
            np.int32)
    elif shape.kind == "retrieval":
        n = shape.dims["n_candidates"]
        out["cand_items"] = rng.integers(0, cfg.item_vocab, (n,)).astype(
            np.int32)
        out["cand_cates"] = rng.integers(0, cfg.cate_vocab, (n,)).astype(
            np.int32)
    elif shape.kind != "recsys_serve":
        raise KeyError(shape.kind)
    return out


def din_batch(cfg: din.DINConfig, shape: ShapeSpec, seed: int = 0,
              device: str | torch.device = "cpu") -> dict:
    """:func:`din_batch_arrays` as tensors on ``device``."""
    return din.batch_to(din_batch_arrays(cfg, shape, seed), device)


# ------------------------------------------------------------ cells -----

#: candidates ``din_retrieval_step`` scores at a time in the retrieval
#: cell: unchunked, 1,000,000 candidates' (N, L, 144) features alone take
#: 57.6 GB; a chunk of 131,072 takes ~18 GB with its hidden tensors
RETRIEVAL_CHUNK = 131_072


@dataclass
class Cell:
    """One (arch x shape) cell.

    ``step(*inputs)`` runs it on inputs shaped as ``abstract_inputs`` (meta
    tensors in the reference's leaf structure: a ``ParamTree`` for the
    parameters a train step updates, AdamW's ``m`` / ``v`` / ``master`` /
    ``step`` state, nested dicts of tensors for the rest; made by
    ``abstract`` on first access, as tracing a full-size init starts
    ``FakeTensorMode``, a few seconds a process);
    ``make_inputs(seed=0, device=...)`` makes concrete ones on ``device``
    (default: the one ``build_cell`` was given): parameters from the
    model's own init drawn from a ``torch.Generator`` seeded with
    ``seed``, ``adamw.init_state``, ids in range, masks, graphs whose
    padded lanes carry weight 0, and for a decode cell a cache of random
    values with ``len = seq_len - 1``.
    A train cell's ``make_state(seed=0, device=...)`` is the first two of
    its inputs alone, the parameters and their AdamW state, drawn as
    ``make_inputs`` draws them (``None`` for a serve cell).
    ``donate`` names the inputs the step may overwrite (the reference's
    donated argnums: the port updates parameters and caches in place),
    ``meta`` the reference's sizes.  ``in_specs`` / ``out_specs`` are the
    layouts of its inputs and outputs (the reference's ``in_shardings`` /
    ``out_shardings`` as spec trees, ``dist.sharding.spec``; AdamW's ``m``
    / ``v`` / ``master`` keyed by parameter name); over a grid
    ``make_inputs`` gives this rank's share and the step returns this
    rank's share of the outputs; ``layout`` is the cell's rank layout
    (``models.lm.Layout``, ``models.gnn.common.GraphLayout`` for a full
    graph, ``models.din.Layout``; ``None`` on one rank)."""

    arch_id: str
    shape_name: str
    step: Callable
    abstract: Callable[[], tuple]
    make_inputs: Callable
    donate: tuple = ()
    meta: dict | None = None
    make_state: Callable | None = None
    family: str = ""
    kind: str = ""
    config: Any = None
    shape: ShapeSpec | None = None
    in_specs: tuple | None = None
    out_specs: Any = None
    layout: Any = None

    @functools.cached_property
    def abstract_inputs(self) -> tuple:
        return self.abstract()


def _tree_map(fn: Callable, tree):
    """``fn`` on every tensor of a tree of dicts, lists and tuples (a
    ``ParamTree``: a new one of meta parameters only)."""
    if isinstance(tree, nn.Module):
        for mod in tree.modules():
            for k, p in list(mod._parameters.items()):
                mod._parameters[k] = nn.Parameter(fn(p.detach()),
                                                  requires_grad=False)
        return tree
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _sds(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    """The reference's ``ShapeDtypeStruct``: a meta tensor."""
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_tree(init: Callable[[torch.Generator], Any]):
    """The tree ``init(gen)`` returns, as meta tensors: traced under
    ``FakeTensorMode`` (no memory, no numbers), so a full-size init costs
    nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = init(torch.Generator())
    return _tree_map(_meta, tree)


def _abstract_train(init: Callable) -> tuple[ParamTree, dict]:
    """Meta parameters as a ``ParamTree`` and their AdamW state."""
    params = ParamTree(abstract_tree(init))
    return params, _tree_map(_meta, adamw.init_state(params))


def input_leaves(tree) -> dict[str, torch.Tensor]:
    """A cell's inputs (or any tree of them) -> {path: tensor}, the path
    the keys and indices from the root joined by '.' (a ``ParamTree``'s
    parameter names and AdamW's state keys are already dotted), as
    ``jax.tree_util.tree_flatten_with_path`` walks the reference's."""
    out: dict[str, torch.Tensor] = {}

    def walk(x, path: tuple):
        if isinstance(x, nn.Module):
            for k, p in x.named_parameters():
                out[".".join(path + (k,))] = p
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, path + (str(k),))
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, path + (str(i),))
        elif isinstance(x, torch.Tensor):
            out[".".join(path)] = x

    walk(tree, ())
    return out


def input_bytes(tree) -> int:
    """Bytes of every tensor of a cell's inputs (meta or concrete)."""
    return sum(t.numel() * t.element_size()
               for t in input_leaves(tree).values())


def _ids(rng: np.random.Generator, high: int, shape: tuple,
         dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(rng.integers(0, high, shape), dtype=torch.int32,
                           device=dev)


# .............................................................. LM .....

MODEL = shd.MODEL_AXIS


def _grid(mesh) -> Grid:
    """The grid a cell's specs are read at (``None``: one rank)."""
    return Grid(1, 1, 0, None, None) if mesh is None else mesh


def _lm_head_specs(cfg, mesh, mode: str = "gqa_tp") -> dict:
    """TP specs for attention weights (the reference's).

    'gqa_tp' (default): shard the QUERY heads over 'model' and replicate
    KV heads when they don't divide the axis -- attention then computes
    locally per head group, with one output all-reduce per layer.  Heads
    that don't divide (minicpm's 36 at 16) replicate the attention
    weights; the attention itself is split by query rows
    (:func:`_chunk_constrainer`).

    'naive_tp' (the reference's recorded baseline, a spec only: no path
    runs it): falls back to sharding the head_dim (contraction) axis when
    head counts don't divide."""
    m = mesh.pm
    heads_ok = cfg.num_heads % m == 0
    kv_ok = cfg.num_kv_heads % m == 0
    if mode == "naive_tp":
        if heads_ok and kv_ok:
            return {"wq": spec(None, None, MODEL, None),
                    "wk": spec(None, None, MODEL, None),
                    "wv": spec(None, None, MODEL, None),
                    "wo": spec(None, MODEL, None, None)}
        assert cfg.head_dim % m == 0
        return {"wq": spec(None, None, None, MODEL),
                "wk": spec(None, None, None, MODEL),
                "wv": spec(None, None, None, MODEL),
                "wo": spec(None, None, MODEL, None)}
    if heads_ok:
        kv = MODEL if kv_ok else None
        return {"wq": spec(None, None, MODEL, None),
                "wk": spec(None, None, kv, None),
                "wv": spec(None, None, kv, None),
                "wo": spec(None, MODEL, None, None)}
    return {"wq": spec(None, None, None, None),
            "wk": spec(None, None, None, None),
            "wv": spec(None, None, None, None),
            "wo": spec(None, None, None, None)}


def lm_param_specs(cfg, mesh, mode: str = "gqa_tp") -> dict:
    specs = shd.lm_param_specs(cfg, mesh, mode="tp")
    specs["layers"]["attn"] = _lm_head_specs(cfg, mesh, mode)
    return specs


def _fsdp_opt_specs(a_params, p_specs, mesh) -> dict:
    """ZeRO-style optimizer-state specs (the reference's): m / v / master
    additionally split their largest unsharded dimension that the data
    axes divide over the data axes.  ``a_params``: the parameter tree's
    shapes (tuples) or tensors."""
    dp = shd.dp_axes(mesh)
    dp_n = shd.dp_size(mesh)

    def leaf_spec(a, sp: tuple, _path) -> tuple:
        shape = tuple(a) if isinstance(a, tuple) else tuple(a.shape)
        parts = list(sp) + [None] * (len(shape) - len(sp))
        best, best_dim = None, -1
        for i, (size, p_) in enumerate(zip(shape, parts, strict=True)):
            if p_ is None and size % dp_n == 0 and size > best_dim:
                best, best_dim = i, size
        if best is None:
            return sp
        parts[best] = dp
        return tuple(parts)

    shard2d = shd.map_specs(leaf_spec, a_params, p_specs)
    return {"m": shard2d, "v": shard2d, "master": shard2d, "step": spec()}


def opt_state_specs(o_specs: dict) -> dict:
    """:func:`_fsdp_opt_specs`' (or ``dist.sharding.opt_state_specs``')
    tree in the port's AdamW layout (``m`` / ``v`` / ``master`` keyed by
    parameter name)."""
    return {k: (shd.flat_specs(v) if k != "step" else v)
            for k, v in o_specs.items()}


def _chunk_constrainer(cfg, mesh):
    """The sequence-parallel attention hook (the reference's) for archs
    whose head count does not divide the model axis (minicpm): each query
    chunk's rows split over 'model' (``inward``), its output whole again
    (``outward``) -> the two specs, or None when the heads divide.  A
    layout with it splits each chunk's rows (``models.lm.Layout
    .seq_chunks``)."""
    if cfg.num_heads % mesh.pm == 0:
        return None
    dp = shd.dp_axes(mesh)
    return {"inward": spec(dp, MODEL, None, None),
            "outward": spec(dp, None, None, None)}


def _lm_kv_specs(cfg, mesh, seq_shard: bool) -> dict:
    """The KV cache's layout (the reference's): KV heads over model; or,
    when they don't divide it, the cache's rows over model; with
    ``seq_shard`` (context parallelism, batch 1) the rows over every
    axis."""
    m = mesh.pm
    dp = shd.dp_axes(mesh)
    if seq_shard:
        axes = (*dp, MODEL)
        return {"k": spec(None, None, axes, None, None),
                "v": spec(None, None, axes, None, None), "len": spec()}
    if cfg.num_kv_heads % m == 0:
        return {"k": spec(None, dp, None, MODEL, None),
                "v": spec(None, dp, None, MODEL, None), "len": spec(dp)}
    return {"k": spec(None, dp, MODEL, None, None),
            "v": spec(None, dp, MODEL, None, None), "len": spec(dp)}


def _splits(sp: tuple, axis: str) -> bool:
    return any(a and axis in a for a in sp)


def lm_layout(cfg, mesh, p_specs: dict, kv_specs: dict | None = None,
              batch: bool = True) -> lm.Layout | None:
    """The ``models.lm.Layout`` the specs give a rank of ``mesh`` (None on
    one rank, which then runs the one-rank path itself)."""
    if mesh is None or mesh.pd * mesh.pm == 1:
        return None
    m = mesh.pm > 1
    attn, ffn = p_specs["layers"]["attn"], p_specs["layers"]["ffn"]
    experts = m and cfg.is_moe and ffn["wi_gate"][1] is not None
    kv_seq = ""
    if kv_specs is not None:
        rows = kv_specs["k"][2]
        if rows and shd.DATA_AXIS in rows:
            kv_seq = "all"
        elif rows and m:
            kv_seq = "model"
    return lm.Layout(
        mesh, vocab=m and _splits(p_specs["embed"], MODEL),
        heads=m and _splits(attn["wq"], MODEL),
        kv_heads=m and _splits(attn["wk"], MODEL),
        ffn=m and not experts and _splits(ffn["wi_gate"], MODEL),
        experts=experts,
        seq_chunks=m and _chunk_constrainer(cfg, mesh) is not None,
        batch=batch, kv_seq=kv_seq)


def lm_zero(mesh, p_specs: dict, o_specs: dict) -> adamw.Zero | None:
    """The ``optim.adamw.Zero`` the specs give a rank of ``mesh`` (None on
    one rank)."""
    if mesh is None or mesh.pd * mesh.pm == 1:
        return None
    flat_p = shd.flat_specs(p_specs)
    flat_o = shd.flat_specs(o_specs["m"])
    split = frozenset(k for k, sp in flat_p.items()
                      if mesh.pm > 1 and _splits(sp, MODEL))
    data_dim = {} if mesh.pd == 1 else {
        k: i for k, sp in flat_o.items() for i, a in enumerate(sp)
        if a and shd.DATA_AXIS in a}
    return adamw.Zero(mesh, split, data_dim)


def _divides(what: str, size: int, parts: int, cell: str) -> None:
    if size % parts:
        raise ValueError(f"{cell}: {what} {size} does not split over "
                         f"{parts} ranks as the reference's specs need")


def _taker(mesh, p_specs: dict) -> Callable | None:
    """``init_lm_params``' ``take``: each drawn leaf's shard."""
    if mesh is None or mesh.pd * mesh.pm == 1:
        return None
    flat = shd.flat_specs(p_specs)
    return lambda path, x: shd.shard(x, flat[path], mesh)


def _lm_params(cfg, seed: int, dev, mesh, p_specs: dict):
    """This rank's parameters: ``init_lm_params`` from a generator seeded
    ``seed``, each leaf sliced as it is drawn -> (tree, the generator)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return lm.init_lm_params(gen, cfg, take=_taker(mesh, p_specs)), gen


def _lm_tokens(rng: np.random.Generator, cfg, shape: tuple, sp: tuple,
               mesh, dev) -> torch.Tensor:
    """Ids in range from ``rng`` at the global ``shape``, this rank's
    share on ``dev`` (drawn whole on the host: ids are small)."""
    ids = rng.integers(0, cfg.vocab_size, shape)
    return torch.as_tensor(shd.shard(ids, sp, _grid(mesh)),
                           dtype=torch.int32, device=dev)


def _lm_train_cell(arch, shape: ShapeSpec, cfg, mesh, device) -> Cell:
    b, s = shape.dims["global_batch"], shape.dims["seq_len"]
    grid = _grid(mesh)
    _divides("global_batch", b, shd.dp_size(grid), arch.arch_id)
    p_specs = lm_param_specs(cfg, grid)
    o_specs = _fsdp_opt_specs(lm.lm_param_shapes(cfg), p_specs, grid)
    b_spec = shd.lm_batch_specs(grid)
    layout = lm_layout(cfg, mesh, p_specs)
    zero = lm_zero(mesh, p_specs, o_specs)
    port_o = opt_state_specs(o_specs)

    def abstract():
        a_params, a_opt = _abstract_train(
            lambda g: lm.init_lm_params(g, cfg))
        a_tok = _sds((b, s), torch.int32)
        return a_params, a_opt, a_tok, a_tok

    def make_state(seed: int = 0, device=device):
        params, _ = _lm_params(cfg, seed, resolve_device(device), mesh,
                               p_specs)
        params = ParamTree(params)
        return params, adamw.init_state(params, zero)

    def make_inputs(seed: int = 0, device=device):
        dev = resolve_device(device)
        params, opt = make_state(seed, dev)
        rng = np.random.default_rng(seed)
        tokens, targets = (_lm_tokens(rng, cfg, (b, s), b_spec, mesh, dev)
                           for _ in range(2))
        return params, opt, tokens, targets

    return Cell(arch.arch_id, shape.name,
                lm_train_step(cfg, layout=layout, zero=zero), abstract,
                make_inputs, donate=(0, 1), meta={"tokens": b * s},
                make_state=make_state,
                in_specs=(p_specs, port_o, b_spec, b_spec),
                out_specs=(p_specs, port_o, spec()), layout=layout)


def _lm_cache(cfg, b: int, s: int, kv_specs: dict, mesh, gen, dev
              ) -> dict:
    """A decode cell's cache: random values from ``gen`` (the K then the
    V of each layer, a layer a draw, ``normal_`` as ``torch.randn`` draws)
    and ``len = s - 1``; a rank keeps its slice of each layer's draw, so
    no rank holds the whole cache, and a rank that keeps all of it draws
    in place."""
    grid = _grid(mesh)
    whole = (b, s, cfg.num_kv_heads, cfg.head_dim)
    cache = {}
    for name in ("k", "v"):
        sp = kv_specs[name][1:]
        local = shd.shard(torch.empty(whole, device="meta"), sp, grid).shape
        out = torch.empty((cfg.num_layers, *local), dtype=cfg.dtype,
                          device=dev)
        for i in range(cfg.num_layers):
            if tuple(local) == whole:
                out[i].normal_(generator=gen)
            else:
                out[i] = shd.shard(torch.empty(
                    whole, dtype=cfg.dtype, device=dev).normal_(
                        generator=gen), sp, grid)
        cache[name] = out
    cache["len"] = shd.shard(torch.full((b,), s - 1, dtype=torch.int32,
                                        device=dev), kv_specs["len"], grid)
    return cache


def _lm_decode_cell(arch, shape: ShapeSpec, cfg, mesh, device) -> Cell:
    b, s = shape.dims["global_batch"], shape.dims["seq_len"]
    seq_shard = bool(shape.dims.get("kv_seq_shard", False))
    grid = _grid(mesh)
    dp_n = shd.dp_size(grid)
    if seq_shard:
        _divides("seq_len", s, grid.pd * grid.pm, arch.arch_id)
    else:
        _divides("global_batch", b, dp_n, arch.arch_id)
    p_specs = lm_param_specs(cfg, grid)
    kv_specs = _lm_kv_specs(cfg, grid, seq_shard)
    if kv_specs["k"][2] == (MODEL,):
        _divides("seq_len", s, grid.pm, arch.arch_id)
    dp = shd.dp_axes(grid)
    split_rows = b >= dp_n
    tok_spec = spec(dp) if split_rows else spec()
    logits_spec = spec(dp, MODEL) if split_rows else spec(None, MODEL)
    layout = lm_layout(cfg, mesh, p_specs, kv_specs, batch=not seq_shard)

    def abstract():
        return (abstract_tree(lambda g: lm.init_lm_params(g, cfg)),
                _tree_map(_meta, lm.init_kv_cache(cfg, b, s, device="meta")),
                _sds((b,), torch.int32))

    def serve_step(params, cache, token):
        gathered = layout is not None and seq_shard and split_rows
        if gathered:
            # the cache holds every row of the batch: so must the step
            token = shd.all_gather_dim(token, layout.data, 0, "dp")
        logits, cache = lm.decode_step(cfg, params, cache, token, layout)
        if gathered:
            logits = logits[shd.data_rows(grid, b)]
        if layout is not None and not layout.vocab and grid.pm > 1:
            logits = shd.shard(logits, spec(None, MODEL), grid)
        return logits, cache

    def make_inputs(seed: int = 0, device=device):
        dev = resolve_device(device)
        params, gen = _lm_params(cfg, seed, dev, mesh, p_specs)
        cache = _lm_cache(cfg, b, s, kv_specs, mesh, gen, dev)
        rng = np.random.default_rng(seed)
        return params, cache, _lm_tokens(rng, cfg, (b,), tok_spec, mesh,
                                         dev)

    return Cell(arch.arch_id, shape.name, serve_step, abstract, make_inputs,
                donate=(1,), meta={"tokens": b, "kv_len": s},
                in_specs=(p_specs, kv_specs, tok_spec),
                out_specs=(logits_spec, kv_specs), layout=layout)


def _lm_prefill_cell(arch, shape: ShapeSpec, cfg, mesh, device) -> Cell:
    b, s = shape.dims["global_batch"], shape.dims["seq_len"]
    grid = _grid(mesh)
    _divides("global_batch", b, shd.dp_size(grid), arch.arch_id)
    p_specs = lm_param_specs(cfg, grid)
    kv_specs = _lm_kv_specs(cfg, grid, seq_shard=False)
    if kv_specs["k"][2] == (MODEL,):
        _divides("seq_len", s, grid.pm, arch.arch_id)
    b_spec = shd.lm_batch_specs(grid)
    logits_spec = spec(shd.dp_axes(grid), MODEL)
    layout = lm_layout(cfg, mesh, p_specs, kv_specs)

    def abstract():
        return (abstract_tree(lambda g: lm.init_lm_params(g, cfg)),
                _sds((b, s), torch.int32))

    def serve_step(params, tokens):
        logits, cache = lm.prefill(cfg, params, tokens, max_len=s,
                                   layout=layout)
        if layout is not None and not layout.vocab and grid.pm > 1:
            logits = shd.shard(logits, spec(None, MODEL), grid)
        return logits, cache

    def make_inputs(seed: int = 0, device=device):
        dev = resolve_device(device)
        params, _ = _lm_params(cfg, seed, dev, mesh, p_specs)
        rng = np.random.default_rng(seed)
        return params, _lm_tokens(rng, cfg, (b, s), b_spec, mesh, dev)

    return Cell(arch.arch_id, shape.name, serve_step, abstract, make_inputs,
                meta={"tokens": b * s}, in_specs=(p_specs, b_spec),
                out_specs=(logits_spec, kv_specs), layout=layout)


# ............................................................. GNN .....

@functools.lru_cache(maxsize=64)
def _gnn_abstract_state(arch_id: str, cfg, d_in: int, n_cls: int) -> tuple:
    """The arch's meta parameters and AdamW state (traced once a process
    for each config: the dry run builds a cell at many grids)."""
    return _abstract_train(
        lambda g: gnn_init_params(g, arch_id, cfg, d_in, n_cls))


def _gnn_cell(arch, shape: ShapeSpec, cfg, mesh, device) -> Cell:
    """``_gnn_full_graph_cell`` (``full_graph``: one graph, no replica
    axis) or ``_gnn_replica_cell`` (``minibatch`` / ``molecule``: a
    leading axis of R replica batches, with graph ids) over ``mesh``.

    A full graph's node rows and edge lanes are rounded up as the
    reference rounds them (``gnn_dims(shape, dp)``); its edges and edge
    mask are split over data, its node tensors by rows for EquiformerV2
    and replicated for the others (the reference's ``node_spec``), and
    each rank computes its rows (``common.GraphLayout``).  A replica cell
    has R = dp replicas, one a data rank, each drawn from
    ``default_rng(seed + r)``.  The parameters and AdamW's state are
    replicated."""
    kind = shape.kind
    grid = _grid(mesh)
    dp = shd.dp_axes(grid)
    r_count = shd.dp_size(grid)
    dims = gnn_dims(shape, r_count)
    d_in, n_cls = dims["d_in"], dims["num_classes"]
    n, e, seeds = dims["nodes"], dims["edges"], dims["seeds"]
    full = kind == "full_graph"
    graph_level = kind == "molecule"
    over = mesh if mesh is not None and mesh.pd * mesh.pm > 1 else None
    inner = gnn_train_step(arch.arch_id, cfg, kind, seeds=seeds or None,
                           grid=over)
    rows_split = arch.arch_id == "equiformer-v2"
    node_spec = spec(dp) if rows_split else spec()

    @functools.cache
    def abstract():
        a_params, a_opt = _gnn_abstract_state(arch.arch_id, cfg, d_in, n_cls)
        f32, i32 = torch.float32, torch.int32
        lead = () if full else (r_count,)
        lab_n = seeds if graph_level else n
        out = (a_params, a_opt, _sds(lead + (e, 2), i32),
               _sds(lead + (e,), f32), _sds(lead + (n, d_in), f32),
               _sds(lead + (n, 3), f32), _sds(lead + (lab_n,), i32),
               _sds(lead + (n,), f32))
        return out if full else out + (_sds(lead + (n,), i32),)

    p_specs = shd.replicate_specs(abstract()[0])
    o_specs = opt_state_specs(shd.opt_state_specs(p_specs))
    if full:
        batch_specs = (spec(dp, None), spec(dp)) + (node_spec,) * 4
    else:
        batch_specs = (spec(dp, None, None), spec(dp, None),
                       spec(dp, None, None), spec(dp, None, None),
                       spec(dp, None), spec(dp, None), spec(dp, None))

    layout = None if over is None or not full else \
        common.GraphLayout(over, n)

    def train_step(params, opt_state, edges, emask, feats, pos, labels,
                   nmask, gid=None):
        if full:
            if layout is not None and not rows_split:
                feats, pos, labels, nmask = (t[layout.rows] for t in
                                             (feats, pos, labels, nmask))
            batches = [common.GraphBatch(edges, emask, feats, nmask, pos,
                                         None, 1, labels)]
        else:
            batches = [common.GraphBatch(
                edges[r], emask[r], feats[r], nmask[r], pos[r],
                gid[r] if graph_level else None,
                seeds if graph_level else 1, labels[r])
                for r in range(edges.shape[0])]
        return inner(params, opt_state, batches)

    def make_state(seed: int = 0, device=device):
        return gnn_train_state(torch.Generator(
            device=resolve_device(device)).manual_seed(seed), arch.arch_id,
            cfg, d_in, n_cls)

    def make_inputs(seed: int = 0, device=device):
        """This rank's share: a full graph's edge lanes (and node rows,
        where split), a replica cell's one replica (at 1 x 1 the whole
        inputs)."""
        dev = resolve_device(device)
        params, opt = make_state(seed, dev)
        keys = ["edges", "edge_mask", "node_feat", "positions", "labels",
                "node_mask"]
        if full:
            a = gnn_replica_arrays(shape, r_count, seed)
            arrays = [shd.shard(a[k], sp, grid)
                      for k, sp in zip(keys, batch_specs, strict=True)]
        else:
            a = gnn_replica_arrays(shape, r_count, seed, grid.data_index)
            if a["graph_id"] is None:
                a["graph_id"] = np.zeros((n,), np.int32)
            arrays = [a[k][None] for k in keys + ["graph_id"]]
        return (params, opt) + tuple(
            torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in arrays)

    meta = ({"edges": e, "nodes": n} if full else
            {"replicas": r_count, "edges_per_replica": e,
             "nodes_per_replica": n})
    return Cell(arch.arch_id, shape.name, train_step, abstract, make_inputs,
                donate=(0, 1), meta=meta, make_state=make_state,
                in_specs=(p_specs, o_specs) + batch_specs,
                out_specs=(p_specs, o_specs, spec()), layout=layout)


# .......................................................... recsys .....

def _din_batch_abstract(cfg: din.DINConfig, batch: int) -> dict:
    i32, ell = torch.int32, cfg.seq_len
    return {"user_id": _sds((batch,), i32),
            "hist_items": _sds((batch, ell), i32),
            "hist_cates": _sds((batch, ell), i32),
            "hist_mask": _sds((batch, ell), torch.float32),
            "target_item": _sds((batch,), i32),
            "target_cate": _sds((batch,), i32)}


def _din_batch_specs(mesh, sharded: bool) -> dict:
    """The reference's: a request batch's rows over data, or replicated."""
    dp = shd.dp_axes(mesh)
    s1 = spec(dp) if sharded else spec()
    s2 = spec(dp, None) if sharded else spec(None, None)
    return {"user_id": s1, "hist_items": s2, "hist_cates": s2,
            "hist_mask": s2, "target_item": s1, "target_cate": s1}


#: DIN's embedding tables, split by vocab rows over the model axis
DIN_TABLES = ("item_table", "cate_table", "user_table")


def _din_cell(arch, shape: ShapeSpec, cfg, mesh, device) -> Cell:
    """``_din_cell`` over ``mesh``: the tables split by vocab over model
    (``din_param_specs``; AdamW's state mirrors them), a request batch's
    rows over data when ``batch >= dp`` (a train batch's labels always),
    a retrieval's candidates over data; the rest replicated.  A rank's
    ``make_inputs`` is the 1 x 1 draw sliced by ``in_specs``."""
    kind = shape.kind
    batch = shape.dims.get("batch", 1)
    init = lambda g: din.init_params(g, cfg)      # noqa: E731
    grid = _grid(mesh)
    dp = shd.dp_axes(grid)
    dp_n = shd.dp_size(grid)
    over = mesh if mesh is not None and mesh.pd * mesh.pm > 1 else None
    sharded = batch >= dp_n
    if grid.pm > 1:
        for name, size in (("item_vocab", cfg.item_vocab),
                           ("cate_vocab", cfg.cate_vocab),
                           ("user_vocab", cfg.user_vocab)):
            _divides(name, size, grid.pm, arch.arch_id)
    if kind == "recsys_train" or (sharded and kind != "retrieval"):
        _divides("batch", batch, dp_n, arch.arch_id)
    p_specs = shd.din_param_specs(grid, cfg)
    b_specs = _din_batch_specs(grid, sharded and kind != "retrieval")
    layout = None if over is None else din.Layout(
        over, vocab=over.pm > 1, batch=batch)

    def whole_params(dev: torch.device, seed: int) -> dict:
        tree = init(torch.Generator(device=dev).manual_seed(seed))
        return tree if over is None else shd.shard_tree(tree, p_specs, grid)

    def batch_in(seed: int, dev: torch.device) -> dict:
        arrays = din_batch_arrays(cfg, shape, seed)
        specs = dict(b_specs, labels=spec(dp), cand_items=spec(dp),
                     cand_cates=spec(dp))
        return din.batch_to({k: shd.shard(v, specs[k], grid)
                             for k, v in arrays.items()}, dev)

    if kind == "recsys_train":
        zero = None if over is None else adamw.Zero(
            over, frozenset(DIN_TABLES) if over.pm > 1 else frozenset())
        o_specs = opt_state_specs(shd.opt_state_specs(p_specs))

        def abstract():
            return _abstract_train(init) + (_din_batch_abstract(cfg, batch),
                                            _sds((batch,), torch.int32))

        def make_state(seed: int = 0, device=device):
            dev = resolve_device(device)
            if over is None:
                return din_train_state(torch.Generator(
                    device=dev).manual_seed(seed), cfg)
            params = ParamTree(whole_params(dev, seed))
            return params, adamw.init_state(params)

        def make_inputs(seed: int = 0, device=device):
            dev = resolve_device(device)
            b = batch_in(seed, dev)
            labels = b.pop("labels")
            params, opt = make_state(seed, dev)
            return params, opt, b, labels

        return Cell(arch.arch_id, shape.name,
                    din_train_step(layout, zero), abstract, make_inputs,
                    donate=(0, 1), meta={"batch": batch},
                    make_state=make_state,
                    in_specs=(p_specs, o_specs, b_specs, spec(dp)),
                    out_specs=(p_specs, o_specs, spec()), layout=layout)

    if kind == "recsys_serve":
        def make_inputs(seed: int = 0, device=device):
            dev = resolve_device(device)
            b = batch_in(seed, dev)
            return whole_params(dev, seed), b

        out_spec = spec(dp, None) if sharded else spec(None, None)
        return Cell(arch.arch_id, shape.name,
                    functools.partial(din_serve_step, layout=layout),
                    lambda: (abstract_tree(init),
                             _din_batch_abstract(cfg, batch)), make_inputs,
                    meta={"batch": batch}, in_specs=(p_specs, b_specs),
                    out_specs=out_spec, layout=layout)

    if kind != "retrieval":
        raise KeyError(kind)
    n_cand = shape.dims["n_candidates"]
    _divides("n_candidates", n_cand, dp_n, arch.arch_id)

    def retrieval_step(params, batch_in, cand_items, cand_cates):
        return din_retrieval_step(params, batch_in, cand_items, cand_cates,
                                  chunk=RETRIEVAL_CHUNK, layout=layout)

    def make_inputs(seed: int = 0, device=device):
        dev = resolve_device(device)
        b = batch_in(seed, dev)
        items, cates = b.pop("cand_items"), b.pop("cand_cates")
        return whole_params(dev, seed), b, items, cates

    i32 = torch.int32
    return Cell(arch.arch_id, shape.name, retrieval_step,
                lambda: (abstract_tree(init), _din_batch_abstract(cfg, 1),
                         _sds((n_cand,), i32), _sds((n_cand,), i32)),
                make_inputs, meta={"candidates": n_cand},
                in_specs=(p_specs, b_specs, spec(dp), spec(dp)),
                out_specs=spec(dp), layout=layout)


# .......................................................... dyngnn .....

def dyngnn_blocks(cfg: dyn_models.DynGNNConfig, edges_per_snap: int,
                  e_pad: int, gen: torch.Generator,
                  device: torch.device) -> tuple:
    """A dyngnn cell's graph inputs, drawn on ``device`` from ``gen``:
    frames (nb, bsize, N, F) uniform in [0, 1); per snapshot
    ``edges_per_snap`` random (src, dst) lanes, N self-loops (the ``A +
    I`` of Eq. 1) and zero lanes up to ``e_pad``, which carry weight 0 as
    ``core.dtdg`` pads them; the Laplacian weights
    (``graph.segment.gcn_edge_weights``); labels in [0, num_classes).
    Made one snapshot at a time: no temporary is larger than a snapshot."""
    n, t, nb = cfg.num_nodes, cfg.num_steps, cfg.checkpoint_blocks
    i32 = torch.int32
    edges = torch.zeros((t, e_pad, 2), dtype=i32, device=device)
    loops = torch.arange(n, dtype=i32, device=device)
    mask = torch.zeros((e_pad,), dtype=torch.float32, device=device)
    mask[:edges_per_snap + n] = 1.0
    weights = torch.empty((t, e_pad), dtype=torch.float32, device=device)
    for i in range(t):
        edges[i, :edges_per_snap].random_(0, n, generator=gen)
        edges[i, edges_per_snap:edges_per_snap + n] = loops[:, None]
        weights[i] = segment.gcn_edge_weights(edges[i], n, mask)
    frames = torch.rand((t, n, cfg.feat_in), generator=gen, device=device)
    labels = torch.randint(0, cfg.num_classes, (t, n), generator=gen,
                           dtype=i32, device=device)

    def blk(a):
        return a.reshape((nb, t // nb) + tuple(a.shape[1:]))

    return blk(frames), blk(edges), blk(weights), blk(labels)


def _dyngnn_cell(arch, shape: ShapeSpec, cfg, grid, device) -> Cell:
    """The paper's workload: the snapshot-partitioned, checkpointed train
    step over ``grid``'s data group, bf16 payloads and the final layer's
    loss fused (``trainer.make_dyngnn_train_step``, built at the first
    step: a grid of ``None`` groups gives the specs alone)."""
    from repro_torch.train import trainer

    if grid is None:
        raise ValueError("a dyngnn cell runs over a process group: pass "
                         "launch.mesh.make_host_mesh(...) (one process: "
                         "launch.mesh.join_one_rank)")
    d = shape.dims
    n, t = d["n_nodes"], d["n_steps"]
    e_pad = _round_up(d["edges_per_snap"] + n, 1024)
    cfg = dataclasses.replace(cfg, num_nodes=n, num_steps=t)
    nb = cfg.checkpoint_blocks
    layout = ShardLayout(grid.data_index, grid.pd, nb, t // nb, n)
    fuse = cfg.model != "evolvegcn"

    @functools.cache
    def built():
        return trainer.make_dyngnn_train_step(
            cfg, grid.data, adamw.AdamWConfig(), comm_dtype=torch.bfloat16,
            fuse_final=True)

    def step(*inputs):
        return built()(*inputs)

    @functools.cache
    def abstract():
        a_params = _tree_map(_meta, dyn_models.init_params(
            torch.Generator().manual_seed(0), cfg))
        bsize, f32 = t // nb, torch.float32
        return (a_params, _tree_map(_meta, adamw.init_state(a_params)),
                _sds((nb, bsize, n, cfg.feat_in), f32),
                _sds((nb, bsize, e_pad, 2), torch.int32),
                _sds((nb, bsize, e_pad), f32),
                _sds((nb, bsize, n), torch.int32))

    def make_state(seed: int = 0, device=device):
        params = dyn_models.init_params(
            torch.Generator().manual_seed(seed), cfg).to(
                resolve_device(device))
        return params, adamw.init_state(params)

    def make_inputs(seed: int = 0, device=device):
        """This rank's share (at P = 1 the whole arrays): its steps of
        each block, and with the fused loss its vertices' labels."""
        dev = resolve_device(device)
        params, opt = make_state(seed, dev)
        frames, edges, ew, labels = dyngnn_blocks(
            cfg, d["edges_per_snap"], e_pad,
            torch.Generator(device=dev).manual_seed(seed), dev)
        labels = (layout.local_vertices(labels) if fuse
                  else layout.local(labels))
        return (params, opt) + tuple(
            a.contiguous() for a in (layout.local(frames),
                                     layout.local(edges), layout.local(ew),
                                     labels))

    # the reference's shardings: a rank's steps of each block, with the
    # fused loss its vertices' labels
    p_specs = shd.replicate_specs(abstract()[0])
    o_specs = opt_state_specs(shd.opt_state_specs(p_specs))
    dp = shd.dp_axes(grid)
    blk = spec(None, dp)
    return Cell(arch.arch_id, shape.name, step, abstract, make_inputs,
                donate=(0, 1),
                meta={"edges_per_snap": e_pad, "nodes": n, "steps": t},
                make_state=make_state,
                in_specs=(p_specs, o_specs, blk, blk, blk,
                          spec(None, None, dp) if fuse else blk),
                out_specs=(p_specs, o_specs, spec()))


# ........................................................ dispatch .....

def build_cell(arch_id: str, shape_name: str, mesh=None,
               smoke: bool = False, shape_override: dict | None = None,
               config_override: dict | None = None,
               device: str | torch.device = "cuda") -> Cell:
    """The cell of ``arch_id`` at ``shape_name`` (its dims updated by
    ``shape_override``), at the smoke config with ``smoke``, the config's
    fields replaced by ``config_override``; ``make_inputs`` defaults to
    ``device``, which must exist (``device="cpu"`` without a card).  A
    dyngnn or LM cell runs over ``mesh`` (a ``Grid``; an LM cell also on
    ``None``, one rank); a GNN or recsys cell takes a 1 x 1 grid or
    ``None`` and refuses more ranks."""
    device = resolve_device(device)
    arch = registry.get_arch(arch_id)
    shape = arch.shapes[shape_name]
    if shape_override:
        shape = ShapeSpec(shape.name, shape.kind,
                          {**shape.dims, **shape_override})
    cfg = arch.make_smoke_config() if smoke else arch.make_config()
    if config_override:
        cfg = dataclasses.replace(cfg, **config_override)
    if arch.family == "lm" and shape.kind == "train":
        cell = _lm_train_cell(arch, shape, cfg, mesh, device)
    elif arch.family == "lm" and shape.kind == "prefill":
        cell = _lm_prefill_cell(arch, shape, cfg, mesh, device)
    elif arch.family == "lm" and shape.kind == "decode":
        cell = _lm_decode_cell(arch, shape, cfg, mesh, device)
    elif arch.family == "gnn" and shape.kind in ("full_graph", "minibatch",
                                                  "molecule"):
        cell = _gnn_cell(arch, shape, cfg, mesh, device)
    elif arch.family == "recsys":
        cell = _din_cell(arch, shape, cfg, mesh, device)
    elif arch.family == "dyngnn":
        cell = _dyngnn_cell(arch, shape, cfg, mesh, device)
        cfg = dataclasses.replace(cfg, num_nodes=shape.dims["n_nodes"],
                                  num_steps=shape.dims["n_steps"])
    else:
        raise KeyError((arch_id, shape_name))
    return dataclasses.replace(cell, family=arch.family, kind=shape.kind,
                               config=cfg, shape=shape)


def all_cells() -> list[tuple[str, str]]:
    """The 40 assigned (arch x shape) pairs and the paper's own cells, in
    the registry's order."""
    return [(arch_id, shape_name)
            for arch_id, arch in registry.all_archs().items()
            for shape_name in arch.shapes]
