"""Process-group rank layout: the counted all-to-alls of snapshot
partitioning (paper §4.2, Fig. 3b) and the cells' tensor-, expert-, data-
and edge-parallel layouts.

Port of ``repro.dist.sharding``.  The reference runs
P devices in one process under ``shard_map`` over the mesh axis
``"data"``; the port runs one process per rank in a ``torch.distributed``
process group — gloo on the CPU, NCCL on the card with rank r on
``cuda:r`` — and the group plays the mesh's part.  A group is
one-dimensional, so its one axis is :data:`DATA_AXIS`.  The hybrid scheme
(paper §6.5) and the cells need the reference's 2-D ``(data, model)``
mesh: a :class:`Grid` of subgroups (:func:`make_grid`) plays it.

* :class:`ShardLayout` — which steps and vertices a rank owns: inside
  every checkpoint block of ``bsize`` steps, rank p owns the ``bsl =
  bsize / P`` contiguous steps from ``p * bsl`` (time-sharded domain),
  and the vertices ``p * N/P ... (p + 1) * N/P - 1`` (vertex-sharded
  domain, where the temporal stage runs).
* :class:`AllToAll` — ``dist.all_to_all_single`` with equal splits as an
  autograd function.  The adjoint of an equal-split all-to-all is the
  same all-to-all, so its backward sends the gradient the same way.
* :func:`all_gather` — one all-gather into one (P, ...) buffer: the
  vertex frame of §4.1 and §6.5 and the sampled schedule's carry rows.
* :func:`t_to_n` / :func:`n_to_t` — the two redistributions of a layer,
  laid out as ``jax.lax.all_to_all(..., tiled=True)`` lays them out.  The
  layout helpers (``t2n_send`` / ``t2n_recv``, ``n2t_send`` /
  ``n2t_recv``) are shared with the int8 all-to-alls of
  ``dist.compression``.

Every all-to-all, forward or backward, adds to three ``obs`` counters:
``partition.a2a_calls``, ``partition.a2a_bytes`` (the bytes this rank
hands to the collective) and ``partition.a2a_remote_bytes`` (the
(P - 1) / P of them that leave the rank).

The cells' layouts (the reference's ``PartitionSpec`` trees, one process a
device):

* a spec is a tuple with one entry a dimension, ``None`` (replicated) or
  a tuple of axis names (split over their product, the first axis
  major), the reference's ``PartitionSpec`` with ``dp_axes`` spelled
  out; :func:`lm_param_specs`, :func:`lm_batch_specs`,
  :func:`din_param_specs`, :func:`replicate_specs`,
  :func:`opt_state_specs` and :func:`dp_axes` are the reference's (a
  grid has no ``pod`` axis);
* :func:`shard_tree` slices a whole tree (tensors or numpy arrays) into
  this rank's shards and :func:`gather_tree` puts the ranks' shards back
  together;
* the collectives a rank program runs over a grid's ``model`` row, its
  ``data`` column or its whole group, each with the adjoint the layout
  needs: :func:`copy_to` (identity forward, all-reduce backward: entering
  a tensor-parallel region), :func:`reduce_from` (all-reduce forward,
  identity backward: leaving a row-parallel product), :func:`gather_from`
  (all-gather forward, this rank's slice backward) and
  :func:`vocab_embedding` (a vocab-split table's lookup: masked local
  rows, then an all-reduce); for the static GNNs' edge split over data,
  :func:`sum_over` (partial per-node sums all-reduced, the gradient
  all-reduced too: each rank reads the sum at its own edges),
  :func:`max_over` (no gradient: ``graph.segment`` routes it to the
  winning lanes; a min is the max of the negation), :func:`gather_rows` (row-split node
  tensors whole: all-gather forward, reduce-scatter backward) and
  :func:`scatter_rows` (partial per-node sums onto their owners' rows:
  reduce-scatter forward, all-gather backward).  Each counts its calls
  and the bytes it hands to the collective under the caller's tag
  (``tp.allreduce_calls``, ``tp.allreduce_bytes``,
  ``dp.allgather_bytes``, ``gnn.reducescatter_bytes``, ...); a one-rank
  group moves nothing and counts nothing.  Sums of bf16 or fp16 partials
  are taken in fp32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
from torch import nn

from repro_torch import obs

#: the one axis of a process group: the snapshot-parallel (data) axis
DATA_AXIS = "data"
#: a grid's second axis: the tensor-parallel (model) axis
MODEL_AXIS = "model"


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


@dataclass(frozen=True)
class ShardLayout:
    """Rank ``rank`` of ``world`` over a timeline of ``nb`` blocks of
    ``bsize`` steps and ``num_nodes`` vertices."""

    rank: int
    world: int
    nb: int
    bsize: int
    num_nodes: int

    def __post_init__(self):
        if self.bsize % self.world:
            raise ValueError(f"block size {self.bsize} does not split over "
                             f"{self.world} ranks (bsize % P != 0)")
        if self.num_nodes % self.world:
            raise ValueError(f"num_nodes {self.num_nodes} does not split "
                             f"over {self.world} ranks (pad the vertex "
                             "axis: ExecutionPlan.auto_pad)")

    @classmethod
    def of(cls, group, nb: int, bsize: int, num_nodes: int) -> ShardLayout:
        return cls(group_rank(group), group_size(group), nb, bsize,
                   num_nodes)

    @property
    def bsl(self) -> int:
        """Steps a rank owns in each block (bsize / P)."""
        return self.bsize // self.world

    @property
    def n_local(self) -> int:
        """Vertices a rank owns in the vertex-sharded domain (N / P)."""
        return self.num_nodes // self.world

    @property
    def steps(self) -> list[int]:
        """The global steps this rank owns, block by block."""
        return [b * self.bsize + self.rank * self.bsl + j
                for b in range(self.nb) for j in range(self.bsl)]

    @property
    def vertices(self) -> slice:
        return slice(self.rank * self.n_local,
                     (self.rank + 1) * self.n_local)

    def local(self, blocked):
        """A blocked (nb, bsize, ...) array -> this rank's (nb, bsl, ...)."""
        return blocked[:, self.rank * self.bsl:(self.rank + 1) * self.bsl]

    def local_vertices(self, blocked):
        """A blocked (nb, bsize, N, ...) array -> this rank's vertex slice
        (nb, bsize, N/P, ...), the layout of fused labels."""
        return blocked[:, :, self.vertices]


@dataclass(frozen=True)
class Grid:
    """This rank's place in a ``pd x pm`` grid of ranks, the reference's
    ``make_host_mesh(data=pd, model=pm)``: rank r sits at data index
    ``r // pm`` and model index ``r % pm`` (its mesh device), so its
    shard of a ``P(data, model, None)`` array is block ``(r // pm, r %
    pm)``.  ``data`` is the rank's grid column (the pd ranks of its model
    index: the snapshot all-to-alls run over it), ``model`` its grid row
    (the pm ranks of its data index: the vertex all-gather and the
    ``hybrid_spmm`` all-reduce run over it), ``whole`` the group of all
    ``pd x pm`` ranks (``None``: the world).  The LM spec functions read
    ``pd`` and ``pm`` alone, so a grid of ``None`` groups stands in for a
    mesh no process group spans."""

    pd: int
    pm: int
    rank: int
    data: Any
    model: Any
    whole: Any = None

    @property
    def data_index(self) -> int:
        return self.rank // self.pm

    @property
    def model_index(self) -> int:
        return self.rank % self.pm


def make_grid(pd: int, pm: int, group=None) -> Grid:
    """Split ``group`` (default: the world) of ``pd * pm`` ranks into the
    grid's columns and rows.  ``dist.new_group`` is collective over the
    whole group, so every rank creates every column and every row, in one
    order, including the groups it is not in; a column or row that spans
    the whole group is the group itself."""
    ranks = (list(range(dist.get_world_size())) if group is None
             else dist.get_process_group_ranks(group))
    if pd < 1 or pm < 1 or pd * pm != len(ranks):
        raise ValueError(f"a {pd} x {pm} grid needs {pd * pm} ranks, the "
                         f"group has {len(ranks)}")
    whole = dist.group.WORLD if group is None else group
    rank = ranks.index(dist.get_rank())

    def new(members):
        return whole if len(members) == len(ranks) else \
            dist.new_group(members)

    columns = [new([ranks[d * pm + m] for d in range(pd)])
               for m in range(pm)]
    rows = [new([ranks[d * pm + m] for m in range(pm)]) for d in range(pd)]
    return Grid(pd, pm, rank, columns[rank % pm], rows[rank // pm],
                None if group is None else group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` from every rank of ``group`` -> (P, *x.shape), stacked in
    group-rank order: one all-gather into one buffer, which NCCL and gloo
    (CUDA tensors too) fill in place.  It hands them the buffer as the
    concatenation along dim 0, the one form gloo takes; an all-gather
    into a list would make NCCL gather into a staging buffer and copy
    out."""
    x = x.contiguous()
    out = x.new_empty((group_size(group),) + tuple(x.shape))
    dist.all_gather_into_tensor(out.flatten(0, 1), x, group=group)
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``dist.all_to_all_single`` with equal splits along dim 0, counted
    (``partition.a2a_calls`` / ``a2a_bytes`` / ``a2a_remote_bytes``, in
    the bytes of ``x``'s own dtype)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    world = group_size(group)
    nbytes = x.numel() * x.element_size()
    obs.inc("partition.a2a_calls")
    obs.inc("partition.a2a_bytes", nbytes)
    obs.inc("partition.a2a_remote_bytes", nbytes // world * (world - 1))
    return out


class AllToAll(torch.autograd.Function):
    """``all_to_all_single`` with equal splits along dim 0, differentiable:
    the backward is the same all-to-all on the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_to_all(grad, ctx.group), None


def t2n_send(h: torch.Tensor, p: int) -> torch.Tensor:
    """Time-sharded (bsl, N, F) -> the (P, bsl, N/P, F) pieces sent by
    ``t_to_n`` (piece q, vertex block q, goes to rank q); a view."""
    bsl, n, f = h.shape
    return h.reshape(bsl, p, n // p, f).permute(1, 0, 2, 3)


def t2n_unsend(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`t2n_send`: (P, bsl, N/P, F) -> (bsl, N, F)."""
    p, bsl, n_loc, f = x.shape
    return x.permute(1, 0, 2, 3).reshape(bsl, p * n_loc, f)


def t2n_recv(y: torch.Tensor) -> torch.Tensor:
    """The (P, bsl, N/P, F) pieces ``t_to_n`` receives, by source rank,
    -> vertex-sharded (P bsl, N/P, F) in time order."""
    p, bsl, n_loc, f = y.shape
    return y.reshape(p * bsl, n_loc, f)


def n2t_send(h: torch.Tensor, p: int) -> torch.Tensor:
    """Vertex-sharded (bsize, N/P, F) -> the (P, bsize/P, N/P, F) pieces
    sent by ``n_to_t`` (piece q, rank q's steps, goes to rank q); a
    view."""
    bsize, n_loc, f = h.shape
    return h.reshape(p, bsize // p, n_loc, f)


def n2t_unsend(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`n2t_send`: (P, bsl, N/P, F) -> (P bsl, N/P,
    F)."""
    p, bsl, n_loc, f = x.shape
    return x.reshape(p * bsl, n_loc, f)


def n2t_recv(y: torch.Tensor) -> torch.Tensor:
    """The (P, bsl, N/P, F) pieces ``n_to_t`` receives, by source rank (=
    vertex block) -> time-sharded (bsl, N, F)."""
    p, bsl, n_loc, f = y.shape
    return y.permute(1, 0, 2, 3).reshape(bsl, p * n_loc, f)


def t_to_n(h: torch.Tensor, group) -> torch.Tensor:
    """Time-sharded (bsl, N, F) -> vertex-sharded (P bsl, N/P, F).

    Rank p sends vertex block q of its steps to rank q and receives its
    own vertex block of every rank's steps, stacked by source rank, which
    is time order (rank q owns steps q bsl ... of the block).  At P = 1
    the permuted view is already contiguous, so nothing is copied; the
    collective is issued all the same."""
    return t2n_recv(AllToAll.apply(t2n_send(h, group_size(group)), group))


def n_to_t(h: torch.Tensor, group) -> torch.Tensor:
    """Vertex-sharded (bsize, N/P, F) -> time-sharded (bsize/P, N, F):
    the inverse of :func:`t_to_n`."""
    return n2t_recv(AllToAll.apply(n2t_send(h, group_size(group)), group))


# ------------------------------------------------------------------ LM ------

#: the data-parallel axis names the reference looks for, pod-major; a
#: grid has ``data`` alone
_DP_NAMES = ("pod", DATA_AXIS)


def axis_sizes(grid) -> dict[str, int]:
    """{axis name: size} of a grid (the reference's ``mesh.shape``)."""
    return {DATA_AXIS: grid.pd, MODEL_AXIS: grid.pm}


def dp_axes(grid) -> tuple:
    """Data-parallel axis names present on the grid, pod-major."""
    return tuple(a for a in _DP_NAMES if a in axis_sizes(grid))


def dp_size(grid) -> int:
    out = 1
    for a in dp_axes(grid):
        out *= axis_sizes(grid)[a]
    return out


def spec(*parts) -> tuple:
    """A spec from the reference's ``P(...)`` arguments: an axis name or a
    tuple of them becomes a tuple, ``None`` stays."""
    return tuple(None if p is None else
                 ((p,) if isinstance(p, str) else tuple(p)) for p in parts)


def _model_if_divisible(dim: int, grid):
    m = grid.pm
    return MODEL_AXIS if m > 1 and dim % m == 0 else None


def lm_param_specs(cfg, grid, mode: str = "tp") -> dict:
    """Megatron-style TP specs for the stacked-layer LM tree (the
    reference's): ``d_ff``, the padded vocabulary, the heads and the KV
    heads split over ``model`` where they divide it; an MoE's experts
    split over ``model`` when E divides it, else each expert's ``d_ff``.
    ``launch.steps.lm_param_specs`` replaces ``["layers"]["attn"]`` with
    the GQA-aware specs."""
    del mode  # one strategy here; steps.py layers variants on top
    ff = _model_if_divisible(cfg.d_ff, grid)
    vocab = _model_if_divisible(cfg.padded_vocab, grid)
    heads = _model_if_divisible(cfg.num_heads, grid)
    kv = _model_if_divisible(cfg.num_kv_heads, grid)
    attn = {"wq": spec(None, None, heads, None),
            "wk": spec(None, None, kv, None),
            "wv": spec(None, None, kv, None),
            "wo": spec(None, heads, None, None)}
    if cfg.is_moe:
        ep = _model_if_divisible(cfg.moe_experts, grid)
        ffn = {"router": spec(),
               "wi_gate": spec(None, ep, None, None if ep else ff),
               "wi_up": spec(None, ep, None, None if ep else ff),
               "wo": spec(None, ep, None if ep else ff, None)}
    else:
        ffn = {"wi_gate": spec(None, None, ff),
               "wi_up": spec(None, None, ff),
               "wo": spec(None, ff, None)}
    return {
        "embed": spec(vocab, None),
        "layers": {"attn": attn, "ffn": ffn, "ln1": spec(), "ln2": spec()},
        "final_norm": spec(),
        "out": spec(None, vocab),
    }


def lm_batch_specs(grid) -> tuple:
    """(B, S) token batches: batch over DP, sequence replicated."""
    return spec(dp_axes(grid), None)


def replicate_specs(tree) -> dict | tuple:
    """A fully replicated spec tree of ``tree``'s structure (nested dicts,
    lists or a ``ParamTree``; a list's entries keyed ``"0"``, ``"1"``,
    ..., as a ``ParamTree`` names them)."""
    if isinstance(tree, nn.Module):
        out: dict = {}
        for name, _ in tree.named_parameters():
            node = out
            *parents, leaf = name.split(".")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = spec()
        return out
    if isinstance(tree, dict):
        return {k: replicate_specs(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): replicate_specs(v) for i, v in enumerate(tree)}
    return spec()


def opt_state_specs(p_specs: dict) -> dict:
    """AdamW state specs (the reference's): m / v / master mirror the
    parameter specs, the step count replicated."""
    return {"m": p_specs, "v": p_specs, "master": p_specs, "step": spec()}


def din_param_specs(grid, cfg) -> dict:
    """DIN (the reference's): the three embedding tables split by vocab
    rows over ``model`` when the grid has more than one model rank, the
    MLP towers replicated; the tree of ``models.din.init_params`` at
    ``cfg``."""
    table = spec(MODEL_AXIS, None) if grid.pm > 1 else spec(None, None)

    def tower(n_layers: int) -> dict:
        return {str(i): {"w": spec(), "b": spec()} for i in range(n_layers)}

    return {"item_table": table, "cate_table": table, "user_table": table,
            "attn_mlp": tower(len(cfg.attn_hidden) + 1),
            "mlp": tower(len(cfg.mlp_hidden) + 1)}


def data_rows(grid, batch: int) -> slice:
    """The reference's ``lm_activation_constrainer`` for one process a
    rank: every activation's leading (batch) dim is this rank's data
    shard, these rows of the global batch."""
    n = batch // grid.pd
    return slice(grid.data_index * n, (grid.data_index + 1) * n)


def _block(grid, axes: tuple) -> tuple[int, int]:
    """(this rank's block index, the number of blocks) of a dimension
    split over ``axes``, the first axis major."""
    coord = {DATA_AXIS: grid.data_index, MODEL_AXIS: grid.model_index}
    size = axis_sizes(grid)
    idx, n = 0, 1
    for a in axes:
        idx, n = idx * size[a] + coord[a], n * size[a]
    return idx, n


def shard_slices(shape: tuple, sp: tuple, grid) -> tuple:
    """The index (one slice a dimension) of this rank's shard of an array
    of ``shape`` under spec ``sp``; a dimension must divide its blocks."""
    out = []
    for dim, size in enumerate(shape):
        axes = sp[dim] if dim < len(sp) else None
        if not axes:
            out.append(slice(None))
            continue
        idx, n = _block(grid, axes)
        if size % n:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"split over {axes} ({n} blocks)")
        w = size // n
        out.append(slice(idx * w, (idx + 1) * w))
    return tuple(out)


def shard(x, sp: tuple, grid):
    """This rank's shard of ``x`` (a tensor or a numpy array) under ``sp``:
    a copy when it is a part of ``x`` (so ``x`` can be freed), ``x``
    itself when the spec keeps it whole."""
    idx = shard_slices(tuple(x.shape), sp, grid)
    if all(s == slice(None) for s in idx):
        return x
    part = x[idx]
    return part.clone() if isinstance(part, torch.Tensor) else part.copy()


def map_specs(fn, tree, specs, path=()):
    """``fn(leaf, spec, path)`` over a tree and its spec tree (the spec
    tree's structure) -> a tree of the same structure."""
    if isinstance(specs, dict):
        if isinstance(tree, (list, tuple)):
            return type(tree)(map_specs(fn, tree[int(k)], specs[k],
                                        path + (k,)) for k in specs)
        return {k: map_specs(fn, _child(tree, k), specs[k], path + (k,))
                for k in specs}
    return fn(tree, specs, path)


def _child(tree, key: str):
    """``tree[key]``; a list's (or ``nn.ModuleList``'s) entry by its
    string index."""
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        return tree[int(key)]
    return tree[key]


def shard_tree(tree, specs, grid):
    """A whole tree (nested dicts of tensors or numpy arrays) -> this
    rank's shards, leaf by leaf under the spec tree of the same
    structure."""
    return map_specs(lambda x, sp, _: shard(x, sp, grid), tree, specs)


def gather_tree(shards: list, specs, grid):
    """The inverse of :func:`shard_tree`: ``shards`` holds every rank's
    tree (rank order) -> the whole tree, each block put where its rank's
    spec places it (ranks holding copies of a block agree; the first
    rank's copy is kept).  ``grid`` gives ``pd`` and ``pm``."""
    ranks = [Grid(grid.pd, grid.pm, r, None, None)
             for r in range(grid.pd * grid.pm)]

    def leaf(_, sp, path):
        parts = [_leaf_at(t, path) for t in shards]
        first = parts[0]
        shape = list(first.shape)
        for dim in range(len(shape)):
            axes = sp[dim] if dim < len(sp) else None
            if axes:
                shape[dim] *= _block(ranks[0], axes)[1]
        if isinstance(first, torch.Tensor):
            out = first.new_empty(shape)
        else:
            import numpy as np
            out = np.empty(shape, first.dtype)
        for g, part in reversed(list(zip(ranks, parts))):
            out[shard_slices(tuple(shape), sp, g)] = part
        return out

    return map_specs(leaf, shards[0], specs)


def _leaf_at(tree, path: tuple):
    for k in path:
        tree = _child(tree, k)
    return tree


def flat_specs(specs, prefix: str = "") -> dict[str, tuple]:
    """A spec tree -> {dotted path: spec}, the keys of a ``ParamTree``'s
    parameters and of AdamW's state."""
    if not isinstance(specs, dict):
        return {prefix: specs}
    out: dict[str, tuple] = {}
    for k, v in specs.items():
        out.update(flat_specs(v, f"{prefix}.{k}" if prefix else k))
    return out


# .................................................... collectives .....

def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _count(tag: str, op: str, t: torch.Tensor) -> None:
    obs.inc(f"{tag}.{op}_calls")
    obs.inc(f"{tag}.{op}_bytes", t.numel() * t.element_size())


def all_reduce(x: torch.Tensor, group, tag: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) of ``x`` over ``group``, a new tensor in ``x``'s
    type (summed in fp32 when ``x`` is bf16 or fp16); ``x`` itself on a
    one-rank group."""
    if _size(group) == 1:
        return x
    low = x.dtype in (torch.bfloat16, torch.float16)
    y = x.to(torch.float32) if low else x.clone()
    y = y.contiguous()
    dist.all_reduce(y, op=op, group=group)
    _count(tag, "allreduce", y)
    return y.to(x.dtype) if low else y


def all_gather_dim(x: torch.Tensor, group, dim: int, tag: str
                   ) -> torch.Tensor:
    """``x`` from every rank of ``group`` concatenated along ``dim`` in
    group-rank order."""
    if _size(group) == 1:
        return x
    out = all_gather(x, group)
    _count(tag, "allgather", out)
    return out.movedim(0, dim).flatten(dim, dim + 1)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tag):
        ctx.group, ctx.tag = group, tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group, ctx.tag), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tag):
        return all_reduce(x, group, tag)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, tag):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.rank = dist.get_rank(group) if _size(group) > 1 else 0
        return all_gather_dim(x, group, dim, tag)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None


def copy_to(x: torch.Tensor, group, tag: str = "tp") -> torch.Tensor:
    """Enter a region that computes partial results from ``x``, a tensor
    every rank of ``group`` holds whole: identity forward, the gradient
    all-reduced over ``group`` backward."""
    return x if _size(group) == 1 else _CopyTo.apply(x, group, tag)


def reduce_from(x: torch.Tensor, group, tag: str = "tp") -> torch.Tensor:
    """Leave a row-parallel product: the partial results all-reduced over
    ``group`` forward, the (whole) gradient passed through backward."""
    return x if _size(group) == 1 else _ReduceFrom.apply(x, group, tag)


def gather_from(x: torch.Tensor, group, dim: int, tag: str = "tp"
                ) -> torch.Tensor:
    """Each rank's part concatenated along ``dim`` forward; backward, this
    rank's part of the (whole) gradient."""
    return x if _size(group) == 1 else _GatherFrom.apply(x, group, dim, tag)


def vocab_embedding(table: torch.Tensor, ids: torch.Tensor, group,
                    vocab_start: int, tag: str = "tp") -> torch.Tensor:
    """Rows ``ids`` of a table split by rows over ``group`` (this rank's
    rows ``vocab_start ...``): ids outside them read row 0 and are zeroed,
    then the ranks' rows are summed (:func:`reduce_from`)."""
    if _size(group) == 1:
        return table[ids.long()]
    local = ids.long() - vocab_start
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(inside, local, 0)]
    rows = rows * inside[..., None].to(rows.dtype)
    return reduce_from(rows, group, tag)


# ......................................... the GNN edge split .....

def _reduce_scatter(x: torch.Tensor, group, tag: str,
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Rows of ``x`` (P n, ...) reduced (``op``) over ``group``: this
    rank's n rows (block ``group rank``), in ``x``'s type (summed in fp32
    when ``x`` is bf16 or fp16)."""
    low = x.dtype in (torch.bfloat16, torch.float16)
    y = (x.to(torch.float32) if low else x).contiguous()
    out = y.new_empty((y.shape[0] // _size(group),) + tuple(y.shape[1:]))
    scatter = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    scatter(out, y, op=op, group=group)
    _count(tag, "reducescatter", y)
    return out.to(x.dtype) if low else out


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tag):
        ctx.group, ctx.tag = group, tag
        return all_reduce(x, group, tag)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group, ctx.tag), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tag):
        ctx.group, ctx.tag = group, tag
        return all_gather_dim(x, group, 0, tag)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.group, ctx.tag), None, None


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tag):
        ctx.group, ctx.tag = group, tag
        return _reduce_scatter(x, group, tag)

    @staticmethod
    def backward(ctx, grad):
        return all_gather_dim(grad, ctx.group, 0, ctx.tag), None, None


def sum_over(x: torch.Tensor, group, tag: str = "gnn") -> torch.Tensor:
    """Partial results (each rank's edges' share) summed over ``group``,
    every rank holding the whole sum and reading it in its own way (at its
    own edges): the gradients the ranks hand back are summed too."""
    return x if _size(group) == 1 else _SumOver.apply(x, group, tag)


def max_over(x: torch.Tensor, group, tag: str = "gnn") -> torch.Tensor:
    """The elementwise max of ``x`` over ``group`` (no gradient)."""
    return all_reduce(x, group, tag, op=dist.ReduceOp.MAX)


def gather_rows(x: torch.Tensor, group, tag: str = "gnn") -> torch.Tensor:
    """Row-split node tensors (this rank's N / P rows) whole, in group-rank
    order: all-gather forward; backward, the ranks' gradients of the whole
    tensor summed onto each rank's rows (reduce-scatter)."""
    return x if _size(group) == 1 else _GatherRows.apply(x, group, tag)


def scatter_rows(x: torch.Tensor, group, tag: str = "gnn") -> torch.Tensor:
    """Partial per-node results (N, ...) summed over ``group`` onto their
    owners: this rank's N / P rows (reduce-scatter forward, all-gather
    backward)."""
    return x if _size(group) == 1 else _ScatterRows.apply(x, group, tag)
