"""Per-family step functions of the launcher: the LM, GNN and recsys
steps.

Port of the LM, GNN and recsys parts of ``repro.launch.steps``:

* :func:`lm_train_step` is ``_lm_train_cell``'s ``train_step`` --
  ``lm_loss`` and its gradients by autograd, then the repo's AdamW
  (``repro_torch.optim.adamw``) on the LM tree held as a
  ``core.models.ParamTree``;
* :func:`gnn_train_step` is the ``train_step`` of ``_gnn_full_graph_cell``
  and ``_gnn_replica_cell`` for the four static GNNs: the node loss over
  ``node_mask`` (``full_graph``), over the first ``seeds`` rows
  (``minibatch``) or per graph (``molecule``), averaged over the replica
  batches (the reference's ``vmap`` then ``mean``), then AdamW
  (``AdamWConfig()``, as there).  :func:`gnn_batches` builds concrete
  batches at a shape's dims (the cells only describe them abstractly);
* the steps of ``_din_cell``: :func:`din_train_step` (``ctr_loss`` and
  its gradients by autograd, then AdamW with ``AdamWConfig()``),
  :func:`din_serve_step` (``forward``) and :func:`din_retrieval_step`
  (``score_candidates``, in chunks on one card where the reference splits
  the candidates over its data-parallel devices); :func:`din_batch`
  builds a concrete batch at a recsys shape's dims.

The reference's sharding specs and activation constrainers have no
counterpart on one device.  The dyngnn cells, the prefill / decode cells
and the multi-device specs (``din_param_specs``' vocab-sharded tables
among them) wait for ROADMAP Queue 1, item 9d (the dyngnn schedules train
through ``repro_torch.run.Engine``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.configs.registry import ShapeSpec
from repro_torch.core.models import ParamTree
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
                      tokens: torch.Tensor, targets: torch.Tensor
                      ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """``lm_loss`` of the ``ParamTree`` ``params`` and its gradients, in
    ``params.named_parameters()`` order."""
    loss = lm.lm_loss(cfg, lm_tree(params), tokens, targets)
    return loss.detach(), torch.autograd.grad(loss, list(params.parameters()))


def lm_train_step(cfg: lm.LMConfig, opt_cfg: adamw.AdamWConfig | None = None
                  ) -> Callable:
    """-> ``step(params, opt_state, tokens, targets) -> (params, opt_state,
    loss)``: one AdamW step on ``lm_loss`` (tokens and targets (B, S)).
    ``params`` is updated in place and returned; ``opt_cfg`` defaults to
    the reference's ``AdamWConfig(schedule=cfg.lr_schedule)``."""
    opt_cfg = opt_cfg or adamw.AdamWConfig(schedule=cfg.lr_schedule)

    def train_step(params: ParamTree, opt_state: dict, tokens: torch.Tensor,
                   targets: torch.Tensor):
        loss, grads = lm_loss_and_grads(cfg, params, tokens, targets)
        params, opt_state = adamw.apply_updates(opt_cfg, params, grads,
                                                opt_state)
        return params, opt_state, loss

    return train_step


# ------------------------------------------------------------- GNN -----

def gnn_logits_fn(arch_id: str, cfg) -> Callable:
    """-> ``logits(params, batch)`` of the arch at ``cfg``."""
    if arch_id == "gatedgcn":
        return gatedgcn.logits
    if arch_id == "pna":
        return pna.logits
    if arch_id == "schnet":
        return lambda p, b: schnet.logits(p, b, cfg.cutoff)
    if arch_id == "equiformer-v2":
        return lambda p, b: equiformer_v2.logits(
            p, b, l_max=cfg.l_max, m_max=cfg.m_max, n_heads=cfg.n_heads,
            n_rbf=cfg.n_rbf, cutoff=cfg.cutoff)
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


def gnn_batch_arrays(shape: ShapeSpec, replicas: int = 1, seed: int = 0
                     ) -> list[dict]:
    """Concrete inputs at ``shape``'s dims, one dict of numpy arrays per
    replica (the ``GraphBatch`` fields), from ``default_rng(seed + r)``:

    * ``molecule``: the reference's ``batch_molecules`` (graphs of the
      shape's nodes and edges, no self-loops, positions in [0, 5)^3);
    * ``full_graph``: ``n_edges`` random (src, dst) pairs without
      self-loops, the edge lanes rounded up to 128 as the cell does, each
      padding lane (0, 1) with mask 0; labels in [0, num_classes);
    * ``minibatch``: the sampled tree of the cell's dims -- ``seeds`` seed
      rows first, then each hop's ``fanout`` children of every node of the
      hop before, one edge child -> parent each; labels on every row (the
      loss reads the seed rows).

    Features are N(0, 1) and positions uniform in [0, 5)^3 for every arch
    (the cells take them whether or not the arch reads them)."""
    dims = gnn_dims(shape, replicas)
    d = shape.dims
    out = []
    for r in range(replicas):
        if shape.kind == "molecule":
            out.append(common.molecule_arrays(
                dims["seeds"], d["n_nodes"], d["n_edges"], d["d_feat"],
                seed=seed + r))
            continue
        rng = np.random.default_rng(seed + r)
        n, e = dims["nodes"], dims["edges"]
        if shape.kind == "full_graph":
            real = d["n_edges"]
            src = rng.integers(0, n, size=real)
            dst = (src + rng.integers(1, n, size=real)) % n
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
        out.append({
            "edges": edges, "edge_mask": emask,
            "node_feat": rng.normal(size=(n, d["d_feat"])).astype(
                np.float32),
            "node_mask": np.ones((n,), np.float32),
            "positions": rng.uniform(0, 5, size=(n, 3)).astype(np.float32),
            "graph_id": None,
            "labels": rng.integers(0, d["num_classes"], size=(n,)).astype(
                np.int32)})
    return out


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
             seeds: int | None = None) -> torch.Tensor:
    """The cell's loss: the mean over the replica batches of the node
    loss over ``node_mask`` (``full_graph``), over the first ``seeds`` rows
    (``minibatch``) or the graph-level loss (``molecule``)."""
    if kind == "minibatch" and not seeds:
        raise ValueError("a minibatch loss needs its seed count")
    losses = []
    for b in batches:
        out = logits_fn(params, b)
        if kind == "molecule":
            losses.append(common.node_ce_loss(
                out, b.labels, torch.ones_like(out[:, 0])))
        elif kind == "minibatch":
            losses.append(common.node_ce_loss(
                out[:seeds], b.labels[:seeds], b.node_mask[:seeds]))
        elif kind == "full_graph":
            losses.append(common.node_ce_loss(out, b.labels, b.node_mask))
        else:
            raise KeyError(kind)
    return torch.stack(losses).mean()


def gnn_loss_and_grads(logits_fn: Callable, kind: str, params: ParamTree,
                       batches: Sequence[common.GraphBatch],
                       seeds: int | None = None
                       ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """:func:`gnn_loss` and its gradients, in ``params.named_parameters()``
    order.  A parameter the loss does not reach (the last GatedGCN layer's
    edge norm) gets a zero gradient, as under ``jax.grad``."""
    loss = gnn_loss(logits_fn, kind, params, batches, seeds)
    grads = torch.autograd.grad(loss, list(params.parameters()),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), grads


def gnn_train_step(arch_id: str, cfg, kind: str, *,
                   seeds: int | None = None,
                   opt_cfg: adamw.AdamWConfig | None = None) -> Callable:
    """-> ``step(params, opt_state, batches) -> (params, opt_state,
    loss)``: one AdamW step on :func:`gnn_loss` over the replica batches
    (one for a full graph).  ``params`` (a ``ParamTree``) is updated in
    place and returned; ``opt_cfg`` defaults to the reference's
    ``AdamWConfig()``."""
    logits_fn = gnn_logits_fn(arch_id, cfg)
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def train_step(params: ParamTree, opt_state: dict,
                   batches: Sequence[common.GraphBatch]):
        loss, grads = gnn_loss_and_grads(logits_fn, kind, params, batches,
                                         seeds)
        params, opt_state = adamw.apply_updates(opt_cfg, params, grads,
                                                opt_state)
        return params, opt_state, loss

    return train_step


# ----------------------------------------------------------- recsys -----

def din_train_state(gen: torch.Generator, cfg: din.DINConfig
                    ) -> tuple[ParamTree, dict]:
    """Fresh DIN parameters from ``gen`` (``din.init_params``) as a
    ``ParamTree`` and their AdamW state (``adamw.init_state``)."""
    params = ParamTree(din.init_params(gen, cfg))
    return params, adamw.init_state(params)


def din_loss_and_grads(params: ParamTree, batch: dict, labels: torch.Tensor
                       ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """``ctr_loss`` and its gradients, in ``params.named_parameters()``
    order (the tables' gradients dense, as under ``jax.grad``)."""
    loss = din.ctr_loss(params, batch, labels)
    return loss.detach(), torch.autograd.grad(loss, list(params.parameters()))


def din_train_step() -> Callable:
    """-> ``step(params, opt_state, batch, labels) -> (params, opt_state,
    loss)``: one AdamW step on ``ctr_loss`` under the reference's
    ``AdamWConfig()``.  ``params`` (a ``ParamTree``) is updated in place
    and returned."""
    opt_cfg = adamw.AdamWConfig()

    def train_step(params: ParamTree, opt_state: dict, batch: dict,
                   labels: torch.Tensor):
        loss, grads = din_loss_and_grads(params, batch, labels)
        params, opt_state = adamw.apply_updates(opt_cfg, params, grads,
                                                opt_state)
        return params, opt_state, loss

    return train_step


@torch.no_grad()
def din_serve_step(params, batch: dict) -> torch.Tensor:
    """The recsys serve cell: ``forward`` -> logits (B, C)."""
    return din.forward(params, batch)


@torch.no_grad()
def din_retrieval_step(params, batch: dict, cand_items: torch.Tensor,
                       cand_cates: torch.Tensor, chunk: int | None = None
                       ) -> torch.Tensor:
    """The retrieval cell: ``score_candidates`` of one user's history
    against (N,) candidates, ``chunk`` at a time -> (N,) scores."""
    return din.score_candidates(params, batch, cand_items, cand_cates,
                                chunk=chunk)


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
