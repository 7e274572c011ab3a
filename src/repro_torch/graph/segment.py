"""Segment-reduction message-passing primitives (port of ``repro.graph.segment``).

Edge-index gathers (``gather_src`` / ``gather_dst``), segment reductions
over destinations (``scatter_sum|mean|max|min|std|softmax``, the static
GNNs' aggregators), degrees and the Laplacian edge weights, all plain
PyTorch (``index_select``, ``index_add``, ``scatter_reduce``): the JAX
package's are XLA gathers and segment ops, no Pallas kernel.  The GCN
aggregate ``A_tilde @ X`` itself (``spmm`` in the JAX package) is
``repro_torch.kernels.segment_spmm``: the CUDA kernel on a CUDA tensor,
its plain version (``ref.py``) on a CPU tensor.

Conventions: ``edges`` is an int32 (E, 2) tensor of (src, dst) columns;
padded edges carry a zero in ``edge_mask`` / a zero weight, so results
never depend on pad contents.  Every index must name a real row: the JAX
segment ops drop an out-of-range id silently, ``index_add`` raises (CPU)
or asserts (CUDA), so a padded edge points at a real node and carries
mask 0.  A node with no (unmasked) in-edge reduces to 0 under every
``scatter_*``, as in the JAX package; ties in ``scatter_max|min`` share
the gradient evenly, as ``jax.ops.segment_max`` does.

Over an edge split (the static GNNs' full-graph cells over a grid's data
ranks) each rank holds a slice of the edges, with global node ids, and
the scatters and :func:`in_degree` take that slice's ``group`` (the data
column): each combines the ranks' partial per-node results into the
global result the whole edge list gives -- sums and counts summed before
a mean or a std divides, maxima and minima combined before the empty
node's fill, the softmax's max and denominator global -- on every rank
(the whole (N, ...) tensor), or with ``rows`` only this rank's N / P rows
of it (group-rank order), for node tensors split by rows.  The gradient
reaches each rank's own lanes: a max's ties share it over all ranks'
tied lanes.  Without a group they are the one-rank functions.
"""

from __future__ import annotations

import torch

from repro_torch.dist import sharding as shd

_NEG_INF = -1e30


def gather_src(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Features of the source endpoint of every edge: (E, ...)."""
    return x.index_select(0, edges[:, 0].long())


def gather_dst(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Features of the destination endpoint of every edge: (E, ...)."""
    return x.index_select(0, edges[:, 1].long())


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(E,) -> (E, 1, ...) broadcasting against ``like``."""
    return v.reshape(v.shape + (1,) * (like.ndim - 1))


def _masked(messages: torch.Tensor, edge_mask: torch.Tensor | None
            ) -> torch.Tensor:
    if edge_mask is None:
        return messages
    return messages * _bcast(edge_mask.to(messages.dtype), messages)


def _combine(partial: torch.Tensor, group, rows: bool) -> torch.Tensor:
    """The ranks' partial per-node sums: the whole sum, or this rank's
    rows of it."""
    if group is None:
        return partial
    return shd.scatter_rows(partial, group) if rows else \
        shd.sum_over(partial, group)


def _own_rows(x: torch.Tensor, group) -> torch.Tensor:
    n = x.shape[0] // shd.group_size(group)
    return x.narrow(0, shd.group_rank(group) * n, n)


def scatter_sum(messages: torch.Tensor, dst: torch.Tensor, num_nodes: int,
                edge_mask: torch.Tensor | None = None, group=None,
                rows: bool = False) -> torch.Tensor:
    """Sum messages (E, ...) into per-node buckets (num_nodes, ...)."""
    msgs = _masked(messages, edge_mask)
    out = msgs.new_zeros((num_nodes,) + msgs.shape[1:])
    return _combine(out.index_add(0, dst.long(), msgs), group, rows)


def scatter_mean(messages: torch.Tensor, dst: torch.Tensor, num_nodes: int,
                 edge_mask: torch.Tensor | None = None, group=None,
                 rows: bool = False) -> torch.Tensor:
    total = scatter_sum(messages, dst, num_nodes, edge_mask, group, rows)
    ones = messages.new_ones(messages.shape[:1])
    cnt = torch.clamp(scatter_sum(ones, dst, num_nodes, edge_mask, group,
                                  rows), min=1.0)
    return total / _bcast(cnt, total)


class _MaxOver(torch.autograd.Function):
    """The per-node max of the ranks' lanes (-inf where none lands), whole
    or this rank's rows; backward, each tied lane of every rank gets its
    node's gradient over the global tie count."""

    @staticmethod
    def forward(ctx, messages, dst, num_nodes, group, rows):
        index = _bcast(dst, messages).expand_as(messages)
        local = messages.new_full((num_nodes,) + messages.shape[1:],
                                  float("-inf")).scatter_reduce(
            0, index, messages, reduce="amax", include_self=False)
        glob = shd.max_over(local, group)
        ctx.save_for_backward(messages, dst, glob)
        ctx.group, ctx.rows = group, rows
        return _own_rows(glob, group) if rows else glob

    @staticmethod
    def backward(ctx, grad):
        messages, dst, glob = ctx.saved_tensors
        group = ctx.group
        whole = shd.all_gather_dim(grad.contiguous(), group, 0, "gnn") \
            if ctx.rows else shd.all_reduce(grad, group, "gnn")
        hit = (messages == glob.index_select(0, dst)).to(messages.dtype)
        ties = shd.all_reduce(torch.zeros_like(glob).index_add(0, dst, hit),
                              group, "gnn")
        share = whole / torch.clamp(ties, min=1.0)
        return hit * share.index_select(0, dst), None, None, None, None


def scatter_max(messages: torch.Tensor, dst: torch.Tensor, num_nodes: int,
                edge_mask: torch.Tensor | None = None, group=None,
                rows: bool = False) -> torch.Tensor:
    """Per-node max; masked lanes count as -1e30 and a node whose lanes
    are all masked, or which has none, comes out 0."""
    if edge_mask is not None:
        messages = torch.where(_bcast(edge_mask, messages) > 0, messages,
                               _NEG_INF)
    if group is not None:
        out = _MaxOver.apply(messages, dst.long(), num_nodes, group, rows)
        return torch.where(out <= _NEG_INF / 2, 0.0, out)
    index = _bcast(dst.long(), messages).expand_as(messages)
    # -inf, not 0, where no lane lands: the backward counts an initial
    # value equal to the max as one more tie, include_self or not
    out = messages.new_full((num_nodes,) + messages.shape[1:],
                            float("-inf"))
    out = out.scatter_reduce(0, index, messages, reduce="amax",
                             include_self=False)
    return torch.where(out <= _NEG_INF / 2, 0.0, out)


def scatter_min(messages: torch.Tensor, dst: torch.Tensor, num_nodes: int,
                edge_mask: torch.Tensor | None = None, group=None,
                rows: bool = False) -> torch.Tensor:
    return -scatter_max(-messages, dst, num_nodes, edge_mask, group, rows)


def scatter_std(messages: torch.Tensor, dst: torch.Tensor, num_nodes: int,
                edge_mask: torch.Tensor | None = None,
                eps: float = 1e-5, group=None,
                rows: bool = False) -> torch.Tensor:
    """Per-node population std of incoming messages (PNA aggregator)."""
    mean = scatter_mean(messages, dst, num_nodes, edge_mask, group, rows)
    mean_sq = scatter_mean(messages * messages, dst, num_nodes, edge_mask,
                           group, rows)
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    return torch.sqrt(var + eps)


def scatter_softmax(logits: torch.Tensor, dst: torch.Tensor, num_nodes: int,
                    edge_mask: torch.Tensor | None = None, group=None
                    ) -> torch.Tensor:
    """Numerically-stable per-destination softmax over edges (GAT-style);
    masked lanes get 0.  Over a ``group`` the max and the denominator are
    the global ones (the max held constant: the softmax does not depend
    on it)."""
    dst = dst.long()
    if group is not None:
        return _softmax_over(logits, dst, num_nodes, edge_mask, group)
    node_max = scatter_max(logits, dst, num_nodes, edge_mask)
    if edge_mask is not None:
        logits = torch.where(_bcast(edge_mask, logits) > 0, logits,
                             _NEG_INF)
    expd = torch.exp(logits - node_max.index_select(0, dst))
    expd = _masked(expd, edge_mask)
    denom = scatter_sum(expd, dst, num_nodes)
    return expd / torch.clamp(denom, min=1e-16).index_select(0, dst)


def _softmax_over(logits: torch.Tensor, dst: torch.Tensor, num_nodes: int,
                  edge_mask: torch.Tensor | None, group) -> torch.Tensor:
    with torch.no_grad():
        node_max = scatter_max(logits, dst, num_nodes, edge_mask, group)
    if edge_mask is not None:
        logits = torch.where(_bcast(edge_mask, logits) > 0, logits,
                             _NEG_INF)
    expd = _masked(torch.exp(logits - node_max.index_select(0, dst)),
                   edge_mask)
    denom = scatter_sum(expd, dst, num_nodes, group=group)
    return expd / torch.clamp(denom, min=1e-16).index_select(0, dst)


def _degree(index: torch.Tensor, num_nodes: int,
            edge_mask: torch.Tensor | None) -> torch.Tensor:
    ones = torch.ones(index.shape[0], dtype=torch.float32,
                      device=index.device)
    if edge_mask is not None:
        ones = ones * edge_mask.to(torch.float32)
    out = torch.zeros(num_nodes, dtype=torch.float32, device=index.device)
    return out.index_add_(0, index.long(), ones)


def in_degree(edges: torch.Tensor, num_nodes: int,
              edge_mask: torch.Tensor | None = None, group=None,
              rows: bool = False) -> torch.Tensor:
    return _combine(_degree(edges[:, 1], num_nodes, edge_mask), group, rows)


def out_degree(edges: torch.Tensor, num_nodes: int,
               edge_mask: torch.Tensor | None = None) -> torch.Tensor:
    return _degree(edges[:, 0], num_nodes, edge_mask)


def gcn_edge_weights(edges: torch.Tensor, num_nodes: int,
                     edge_mask: torch.Tensor | None = None,
                     edge_values: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """Symmetric-normalized Laplacian edge weights (Eq. 1 of the paper).

    w(u, v) = val(u, v) / sqrt((1 + deg_u) (1 + deg_v)); the "+1" is the
    identity (self-loop) term of ``A + I``.  Out-degree on the source,
    in-degree on the destination, as the JAX package does for directed
    snapshots.
    """
    inv_sqrt_in = torch.rsqrt(1.0 + in_degree(edges, num_nodes, edge_mask))
    inv_sqrt_out = torch.rsqrt(1.0 + out_degree(edges, num_nodes,
                                                edge_mask))
    w = inv_sqrt_out[edges[:, 0].long()] * inv_sqrt_in[edges[:, 1].long()]
    if edge_values is not None:
        w = w * edge_values
    if edge_mask is not None:
        w = w * edge_mask.to(w.dtype)
    return w
