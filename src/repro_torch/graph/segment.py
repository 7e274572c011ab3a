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
"""

from __future__ import annotations

import torch

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


def scatter_sum(messages: torch.Tensor, dst: torch.Tensor, num_nodes: int,
                edge_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Sum messages (E, ...) into per-node buckets (num_nodes, ...)."""
    msgs = _masked(messages, edge_mask)
    out = msgs.new_zeros((num_nodes,) + msgs.shape[1:])
    return out.index_add(0, dst.long(), msgs)


def scatter_mean(messages: torch.Tensor, dst: torch.Tensor, num_nodes: int,
                 edge_mask: torch.Tensor | None = None) -> torch.Tensor:
    total = scatter_sum(messages, dst, num_nodes, edge_mask)
    ones = messages.new_ones(messages.shape[:1])
    cnt = torch.clamp(scatter_sum(ones, dst, num_nodes, edge_mask), min=1.0)
    return total / _bcast(cnt, total)


def scatter_max(messages: torch.Tensor, dst: torch.Tensor, num_nodes: int,
                edge_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-node max; masked lanes count as -1e30 and a node whose lanes
    are all masked, or which has none, comes out 0."""
    if edge_mask is not None:
        messages = torch.where(_bcast(edge_mask, messages) > 0, messages,
                               _NEG_INF)
    index = _bcast(dst.long(), messages).expand_as(messages)
    # -inf, not 0, where no lane lands: the backward counts an initial
    # value equal to the max as one more tie, include_self or not
    out = messages.new_full((num_nodes,) + messages.shape[1:],
                            float("-inf"))
    out = out.scatter_reduce(0, index, messages, reduce="amax",
                             include_self=False)
    return torch.where(out <= _NEG_INF / 2, 0.0, out)


def scatter_min(messages: torch.Tensor, dst: torch.Tensor, num_nodes: int,
                edge_mask: torch.Tensor | None = None) -> torch.Tensor:
    return -scatter_max(-messages, dst, num_nodes, edge_mask)


def scatter_std(messages: torch.Tensor, dst: torch.Tensor, num_nodes: int,
                edge_mask: torch.Tensor | None = None,
                eps: float = 1e-5) -> torch.Tensor:
    """Per-node population std of incoming messages (PNA aggregator)."""
    mean = scatter_mean(messages, dst, num_nodes, edge_mask)
    mean_sq = scatter_mean(messages * messages, dst, num_nodes, edge_mask)
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    return torch.sqrt(var + eps)


def scatter_softmax(logits: torch.Tensor, dst: torch.Tensor, num_nodes: int,
                    edge_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Numerically-stable per-destination softmax over edges (GAT-style);
    masked lanes get 0."""
    dst = dst.long()
    node_max = scatter_max(logits, dst, num_nodes, edge_mask)
    if edge_mask is not None:
        logits = torch.where(_bcast(edge_mask, logits) > 0, logits,
                             _NEG_INF)
    expd = torch.exp(logits - node_max.index_select(0, dst))
    expd = _masked(expd, edge_mask)
    denom = scatter_sum(expd, dst, num_nodes)
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
              edge_mask: torch.Tensor | None = None) -> torch.Tensor:
    return _degree(edges[:, 1], num_nodes, edge_mask)


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
