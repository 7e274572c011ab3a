"""Data-distribution schemes for dynamic-GNN training (paper §4), on a
``torch.distributed`` process group.

Port of ``repro.core.partition``.  The reference writes each scheme as a
``shard_map`` body over P devices of one process; here every function
runs in each rank's process on that rank's local arrays, and the
collectives go through the group (``repro_torch.dist.sharding``).

* ``snapshot_*`` — the paper's contribution (§4.2): shard the TIME axis.
  The GCN stage is communication-free; the temporal stage is reached
  through an all-to-all that re-shards T-major -> N-major and a second
  all-to-all back.  Fixed O(T N) volume per layer, for any P.
* ``vertex_*`` — the baseline (§4.1): shard the VERTEX axis; the temporal
  stage is local but the GCN needs remote neighbour features, here the
  all-gathered frame (the dense upper bound of the hypergraph scheme; the
  analytic volumes are in ``repro_torch.dist.comm_volume``).  Forward
  only, as in the reference.

The hybrid scheme (§6.5, ``hybrid_spmm``) needs a 2-D grid of subgroups
and waits for ROADMAP Queue 1, item 5b.

Each checkpoint block of the eager trainer is one non-reentrant
``torch.utils.checkpoint`` call with its all-to-alls inside, so the
backward's recompute issues the block's forward all-to-alls again (up to
the last tensor its backward needs: PyTorch's early stop).  The
distributed stream (``stream.distributed``) runs ``snapshot_block_body``
once per round without a checkpoint, which its int8 all-to-alls need:
their error-feedback residual advances once per forward.  Every rank
runs the same graph and so issues the same collectives in the same
order; the only rank-dependent step inside a block is EvolveGCN's slice
of the evolved weights.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.core import gcn as gcnlib
from repro_torch.core import models as mdl
from repro_torch.core import temporal
from repro_torch.core.dtdg import DTDGBatch
from repro_torch.dist import compression as compression_lib
from repro_torch.dist.sharding import group_rank, group_size, n_to_t, t_to_n
from repro_torch.kernels.segment_spmm import ops as spmm_ops


# ------------------------------------------------- snapshot partitioning ----

def snapshot_block_body(cfg: mdl.DynGNNConfig, params: mdl.ParamTree, group,
                        carries: list, blk: tuple, csrs: list, *,
                        comm_dtype=None, fused_labels: bool = False,
                        a2a_chunks: int = 1, compression: str = "none",
                        comm_residuals: list | None = None):
    """One checkpoint block under snapshot partitioning (Fig. 3b), on this
    rank.

    ``blk`` is ``(x_b (bsl, N, F), e_b (bsl, E, 2), w_b (bsl, E), t0)``,
    the rank's ``bsl = bsize / P`` steps of the block and the block's first
    global step ``t0 = b bsize``, plus the vertex-sharded labels
    ``(bsize, N/P)`` when ``fused_labels``; ``csrs`` the (CSR, transposed
    CSR) pair of each of the rank's steps.  The temporal carries are
    vertex-sharded (N/P rows).  Returns ``(new_carries, h,
    new_comm_residuals)`` with the time-sharded block output h (bsl, N,
    out), or the NLL sum in its place when ``fused_labels``;
    ``new_comm_residuals`` is None when ``compression`` is "none".

    Options (the reference's):
      * ``comm_dtype`` — cast each all-to-all payload (e.g. bf16), and
        only the payload: compute stays in the working dtype;
      * ``fused_labels`` — the last layer's loss is taken in the
        vertex-sharded domain (the classifier is per (t, u)), so the last
        N -> T all-to-all is dropped;
      * ``a2a_chunks`` — C all-to-alls over feature slices instead of one
        (math-identical);
      * ``compression`` != "none" — int8 error-feedback all-to-alls
        (``dist.compression``).  ``comm_residuals`` then holds one
        ``(res_t2n (bsl, N, f_t2n), res_n2t (bsize, N/P, f_n2t))`` pair
        per layer in the PRE-all-to-all layouts (``a2a_payload_dims``;
        none for EvolveGCN), chunking cuts payload and residual at the
        same features (each chunk keeps its own scales), and the body
        returns the residuals updated, in the same layout.  It composes
        with ``a2a_chunks`` only.
    """
    compress = compression_lib.compresses_a2a(compression)
    if compress:
        if comm_dtype is not None or fused_labels:
            raise ValueError(
                "compression composes with a2a_chunks only, not with "
                "comm_dtype/fused_labels")
        if comm_residuals is None:
            raise ValueError(
                "compression != 'none' requires comm_residuals "
                "(stream.distributed.init_comm_residuals)")
    if fused_labels:
        x_b, e_b, w_b, t0, labels_b = blk
    else:
        x_b, e_b, w_b, t0 = blk
        labels_b = None
    p, rank = group_size(group), group_rank(group)
    bsl, num_nodes = x_b.shape[0], x_b.shape[1]

    def cut(y):
        width = y.shape[-1]
        return torch.tensor_split(
            y, [width * c // a2a_chunks for c in range(1, a2a_chunks)],
            dim=-1)

    def join(pieces):
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=-1)

    def a2a(y, res, plain, quantized):
        """One redistribution as ``a2a_chunks`` feature-sliced all-to-alls:
        f32 (cast to ``comm_dtype`` on the wire) when ``res`` is None, else
        the int8 wire with payload and residual cut at the same features
        -> (out, the new residual or None)."""
        if res is None:
            return join([plain(yp if comm_dtype is None
                               else yp.to(comm_dtype), group).to(y.dtype)
                         for yp in cut(y)]), None
        outs = [quantized(yp, rp, group)
                for yp, rp in zip(cut(y), cut(res), strict=True)]
        return join([o for o, _ in outs]), join([r for _, r in outs])

    h = x_b
    new_carries = []
    new_comm_res = []
    for l in range(cfg.num_layers):
        lp = params["layers"][l]
        if cfg.model == "evolvegcn":
            # every rank evolves the block's weights from the carried
            # boundary state (they are tiny, §5.5) and keeps its own steps;
            # the feature path needs no redistribution
            w_prev, st = carries[l]
            ws, w_last, st_last = temporal.evolve_weights_from(
                lp["evolve"], w_prev, st, bsl * p)
            ws_local = ws[rank * bsl:(rank + 1) * bsl]
            h = torch.stack([
                torch.relu(gcnlib.spatial_aggregate(
                    h[t], e_b[t], w_b[t], num_nodes, *csrs[t]) @ ws_local[t])
                for t in range(bsl)])
            new_carries.append((w_last, st_last))
            continue
        # spatial stage: whole snapshots are local, no communication
        h, _ = mdl.spatial_stage(cfg, lp, h, e_b, w_b, None, csrs)
        res_t2n, res_n2t = comm_residuals[l] if compress else (None, None)
        # T-sharded -> N-sharded
        h, nr1 = a2a(h, res_t2n, t_to_n, compression_lib.quantized_t_to_n)
        # temporal stage: the block's whole timeline, local vertices
        h, c_tm = mdl.temporal_stage(cfg, lp, h, carries[l], t0)
        new_carries.append(c_tm)
        if l == cfg.num_layers - 1 and labels_b is not None:
            return new_carries, _nll(params, h, labels_b).sum(), None
        # N-sharded -> T-sharded
        h, nr2 = a2a(h, res_n2t, n_to_t, compression_lib.quantized_n_to_t)
        new_comm_res.append((nr1, nr2))
    # EvolveGCN redistributes nothing, so its list is empty
    return new_carries, h, new_comm_res if compress else None


def _nll(params, z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(mdl.classify(params, z).to(torch.float32),
                             dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def a2a_payload_dims(cfg: mdl.DynGNNConfig) -> list[tuple[int, int]]:
    """Per-layer feature widths ``(f_t2n, f_n2t)`` of the two
    redistributions in ``snapshot_block_body``.

    The T->N payload is the spatial-stage output (cdgcn concatenates the
    aggregate with the GCN transform, so it is ``d_in + d_gcn`` wide);
    the N->T payload is the temporal-stage output.  EvolveGCN
    redistributes nothing (§5.5) — empty list.
    """
    if cfg.model == "evolvegcn":
        return []
    return [(d_in + d_gcn if cfg.model == "cdgcn" else d_out, d_out)
            for d_in, d_gcn, d_out in cfg.layer_dims()]


def local_csrs(edges: torch.Tensor, edge_weights: torch.Tensor,
               num_nodes: int) -> list:
    """The (CSR, transposed CSR) pair of each of a rank's blocked steps
    (nb, bsl, E, ...), block by block; the forward CSR alone (no
    transpose) when no gradient is recorded."""
    pairs = torch.is_grad_enabled()
    return [spmm_ops.build_csr_pair(e, w, num_nodes) if pairs
            else (spmm_ops.build_csr(e, w, num_nodes), None)
            for e, w in zip(edges.flatten(0, 1), edge_weights.flatten(0, 1),
                            strict=True)]


def _blocks(cfg, params, group, frames, edges, ew, csrs, labels=None,
            **opts):
    """Run the rank's blocks in order, each under non-reentrant
    checkpointing when a gradient is recorded -> each block's output."""
    nb, bsl, num_nodes = frames.shape[:3]
    p = group_size(group)
    carries = mdl.init_carries(cfg, params, dtype=frames.dtype,
                               device=frames.device,
                               num_local_nodes=num_nodes // p)
    if csrs is None:
        csrs = local_csrs(edges, ew, num_nodes)
    record = torch.is_grad_enabled()
    outs = []
    for b in range(nb):
        blk = (frames[b], edges[b], ew[b], b * bsl * p)
        if labels is not None:
            blk += (labels[b],)
        args = (cfg, params, group, carries, blk,
                csrs[b * bsl:(b + 1) * bsl])
        if record:
            carries, out, _ = checkpoint(snapshot_block_body, *args,
                                         use_reentrant=False, **opts)
        else:
            carries, out, _ = snapshot_block_body(*args, **opts)
        outs.append(out)
    return outs


def snapshot_partition_forward(cfg: mdl.DynGNNConfig, group,
                               a2a_chunks: int = 1):
    """The sharded forward: ``fn(params, frames, edges, ew, csrs=None) ->
    Z``, on this rank's blocked steps (nb, bsl, ...) -> its (nb, bsl, N,
    out) share of Z (rank p holds steps p bsl ... of each block, Fig. 3b).
    ``csrs``: :func:`local_csrs` of the rank's steps, built once by the
    caller (built here when None).  ``a2a_chunks > 1`` chunks every
    redistribution into that many feature-sliced all-to-alls
    (math-identical)."""

    def fn(params, frames, edges, ew, csrs=None):
        return torch.stack(_blocks(cfg, params, group, frames, edges, ew,
                                   csrs, a2a_chunks=a2a_chunks))

    return fn


def snapshot_partition_loss(cfg: mdl.DynGNNConfig, group, comm_dtype=None,
                            fuse_final: bool = False, a2a_chunks: int = 1):
    """This rank's share of the mean CE over all (t, u):
    ``fn(params, frames, edges, ew, labels, csrs=None)`` -> the rank's NLL
    sum over the global count T N (padded vertices included, as in the
    reference), a number the rank knows without communication.

    The shares sum to the loss over the ranks.  Differentiating a share
    with respect to the replicated parameters reaches every rank's loss
    through the all-to-alls' backward, so the gradient of the loss is the
    sum of the ranks' gradients (one all-reduce per leaf; see
    ``train.trainer.make_dyngnn_train_step``).  Never all-reduce the loss
    inside autograd: the all-reduce's backward sums again, P times too
    much.

    ``labels``: the rank's (nb, bsl, N), or with ``fuse_final`` its
    vertex-sharded (nb, bsize, N/P) (``ShardLayout.local_vertices``), the
    last N -> T all-to-all then dropped; ``comm_dtype`` casts the payloads;
    ``a2a_chunks`` splits each redistribution.  All off = the paper's
    execution.
    """
    fuse = fuse_final and cfg.model != "evolvegcn"

    def fn(params, frames, edges, ew, labels, csrs=None):
        nb, bsl, num_nodes = frames.shape[:3]
        count = nb * bsl * group_size(group) * num_nodes
        outs = _blocks(cfg, params, group, frames, edges, ew, csrs,
                       labels if fuse else None, comm_dtype=comm_dtype,
                       fused_labels=fuse, a2a_chunks=a2a_chunks)
        if fuse:
            return torch.stack(outs).sum() / count
        z = torch.cat(outs)                               # (nb bsl, N, F')
        lab = labels.reshape((nb * bsl,) + tuple(labels.shape[2:]))
        return _nll(params, z, lab).sum() / count

    return fn


def blockify_batch(batch: DTDGBatch, nb: int) -> tuple:
    """Reshape a DTDG batch to (nb, bsize, ...) frames, edges and edge
    weights (views).  On a rank's own batch (``DTDGPipeline.rank_batch``)
    that is its (nb, bsl, ...) share."""
    def blk(a):
        t = a.shape[0]
        return a.reshape((nb, t // nb) + tuple(a.shape[1:]))
    return (blk(batch.frames), blk(batch.edges), blk(batch.edge_weights))


# --------------------------------------------------- vertex partitioning ----

def _gather_frame(h: torch.Tensor, group) -> torch.Tensor:
    """(T, N/P, F) -> the whole (T, N, F) frame on every rank."""
    p = group_size(group)
    t, n_loc, f = h.shape
    out = h.new_empty((p * t, n_loc, f))
    dist.all_gather_into_tensor(out, h.contiguous(), group=group)
    return out.reshape(p, t, n_loc, f).permute(1, 0, 2, 3).reshape(
        t, p * n_loc, f)


def vertex_partition_forward(cfg: mdl.DynGNNConfig, group):
    """Baseline §4.1: vertices sharded; the GCN gathers remote features.

    ``fn(params, frames (T, N/P, F), edges (T, E_loc, 2), ew (T, E_loc))
    -> the rank's (T, N/P, out)``.  Each rank holds the edges whose
    destination it owns, with GLOBAL source and LOCAL destination ids
    (:func:`partition_edges_by_dst`), and all-gathers the frame per layer
    (the regular-pattern upper bound of vertex partitioning: its volume
    grows ~P, unlike snapshots').  The local aggregate is a plain
    ``index_add_``, as the reference's is a plain ``segment_sum``.  The
    temporal stage is local, as in the paper.  Forward only.
    """

    def fn(params, frames, edges, ew):
        t_steps, n_local = frames.shape[:2]
        carries = mdl.init_carries(cfg, params, dtype=frames.dtype,
                                   device=frames.device,
                                   num_local_nodes=n_local)

        def agg(x_full, e, w):
            msgs = x_full[e[:, 0].long()] * w[:, None].to(x_full.dtype)
            return x_full.new_zeros((n_local, x_full.shape[1])).index_add_(
                0, e[:, 1].long(), msgs)

        h = frames
        for l in range(cfg.num_layers):
            lp = params["layers"][l]
            h_full = _gather_frame(h, group)
            y0 = torch.stack([agg(h_full[t], edges[t], ew[t])
                              for t in range(t_steps)])
            if cfg.model == "evolvegcn":
                w_prev, st = carries[l]
                ws, _, _ = temporal.evolve_weights_from(
                    lp["evolve"], w_prev, st, t_steps)
                h = torch.relu(torch.einsum("tnf,tfg->tng", y0, ws))
                continue
            y1 = y0 @ lp["gcn"]["w"] + lp["gcn"]["b"]
            h2 = torch.relu(torch.cat([y0, y1], dim=-1)
                            if cfg.model == "cdgcn" else y1)
            h, _ = mdl.temporal_stage(cfg, lp, h2, carries[l], 0)
        return h

    return fn


def partition_edges_by_dst(edges_padded, masks, num_nodes: int,
                           num_procs: int, max_local_edges: int):
    """Host-side dst-shard edge partitioning for the vertex baseline.

    Returns (T, P, E_loc, 2) with src GLOBAL / dst LOCAL ids and the matching
    mask, ready to be fed shard-wise.
    """
    t_steps = edges_padded.shape[0]
    n_per = num_nodes // num_procs
    out_e = np.zeros((t_steps, num_procs, max_local_edges, 2), dtype=np.int32)
    out_w = np.zeros((t_steps, num_procs, max_local_edges), dtype=np.float32)
    for t in range(t_steps):
        e = np.asarray(edges_padded[t])
        m = np.asarray(masks[t]) > 0
        e = e[m]
        w = np.asarray(masks[t])[m]
        owner = e[:, 1] // n_per
        for p in range(num_procs):
            sel = e[owner == p]
            wsel = w[owner == p]
            k = min(sel.shape[0], max_local_edges)
            out_e[t, p, :k, 0] = sel[:k, 0]
            out_e[t, p, :k, 1] = sel[:k, 1] % n_per
            out_w[t, p, :k] = wsel[:k]
    return out_e, out_w
