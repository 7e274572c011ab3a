"""Hybrid partitioning (paper §6.5): snapshot groups x intra-snapshot vertex
sharding, for snapshots too large for one device (AMLSim-Large: 2.2-3.2 B
nnz, 44-64 GB per §6.5), or when T < P would leave processors idle.

Port of ``repro.core.hybrid``.  The reference runs a ``shard_map`` over a
2-D ``(data, model)`` mesh; here every rank runs :func:`hybrid_forward`'s
function on its own blocks, and a :class:`~repro_torch.dist.sharding.Grid`
of subgroups plays the mesh (rank r at data index r // Pm, model index
r % Pm):

* features live vertex-sharded: a rank holds (T/Pd, N/Pm, F), block
  (r // Pm, r % Pm) of the reference's ``P(data, model, None)`` layout;
* the GCN aggregate all-gathers the frame over the rank's ``model`` group
  and aggregates the rank's destination shard of the edges through the
  ``segment_spmm`` wrapper, on a rectangular CSR (N/Pm local destination
  rows, N global source rows) built once per snapshot for all layers;
* the temporal stage re-shards T-major -> N-major over the ``data`` group
  exactly as snapshot partitioning does (``dist.sharding.t_to_n`` /
  ``n_to_t``), so each rank ends with N/(Pd Pm) timelines;
* volume: O(T N) over ``data`` (the paper's law) plus O(T/Pd N) over
  ``model``.

It is forward-only, like the reference, and runs under ``torch.no_grad``.
EvolveGCN is refused: the reference's ``hybrid_forward`` reads every
layer's ``gcn`` parameters, which EvolveGCN's layers do not have.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import models as mdl
from repro_torch.core.partition import gather_frame
from repro_torch.dist.sharding import Grid, n_to_t, t_to_n
from repro_torch.kernels.segment_spmm import ops as spmm_ops


def hybrid_forward(cfg: mdl.DynGNNConfig, grid: Grid):
    """Builds ``fn(params, frames, edges, ew) -> Z`` on this rank's blocks.

    Local layouts (this rank's blocks of the reference's global arrays):
      frames (T/Pd, N/Pm, F)  block (data index, model index)
      edges  (T/Pd, E_loc, 2) the rank's destination shard of each of its
                              snapshots (dst ids LOCAL, src GLOBAL), as
                              :func:`partition_edges_for_hybrid` stacks them
      ew     (T/Pd, E_loc)    their weights, zero on padded lanes
    Output Z (T/Pd, N/Pm, F'), the rank's block of the reference's output.
    """
    if cfg.model == "evolvegcn":
        raise ValueError(
            "hybrid_forward runs tmgcn and cdgcn: the reference's "
            "repro.core.hybrid.hybrid_forward reads each layer's 'gcn' "
            "parameters, which EvolveGCN's layers (its 'evolve' weight "
            "LSTM) do not have, so it fails there")

    def fn(params, frames, edges, ew):
        with torch.no_grad():
            n_loc = frames.shape[1]
            # one rectangular CSR per snapshot, shared by the layers
            csrs = [spmm_ops.build_csr(e, w, n_loc)
                    for e, w in zip(edges, ew, strict=True)]
            h = frames
            for l in range(cfg.num_layers):
                lp = params["layers"][l]
                # ---- spatial stage: blockwise intra-snapshot SpMM -------
                x_full = gather_frame(h, grid.model)    # (T/Pd, N, F)
                y0 = torch.stack([
                    spmm_ops.segment_spmm_csr(x_full[t].contiguous(), *csr)
                    for t, csr in enumerate(csrs)])     # (T/Pd, N/Pm, F)
                y1 = y0 @ lp["gcn"]["w"] + lp["gcn"]["b"]
                y = torch.relu(torch.cat([y0, y1], dim=-1)
                               if cfg.model == "cdgcn" else y1)
                # ---- temporal stage: T-major -> N-major over data -------
                y = t_to_n(y, grid.data)            # (T, N/(Pd Pm), F')
                carry = mdl.init_layer_carry(cfg, params, l, dtype=y.dtype,
                                             device=y.device,
                                             num_local_nodes=y.shape[1])
                z, _ = mdl.temporal_stage(cfg, lp, y, carry, 0)
                h = n_to_t(z, grid.data)
            return h

    return fn


def local_blocks(grid: Grid, frames, edges, ew) -> tuple:
    """This rank's blocks of the global (T, N, F) frames and of
    :func:`partition_edges_for_hybrid`'s (T, Pm E_loc, 2) edges and
    (T, Pm E_loc) weights -> (frames, edges, ew) as ``hybrid_forward``'s
    function takes them (views)."""
    t_loc = frames.shape[0] // grid.pd
    n_loc = frames.shape[1] // grid.pm
    e_loc = edges.shape[1] // grid.pm
    ts = slice(grid.data_index * t_loc, (grid.data_index + 1) * t_loc)
    es = slice(grid.model_index * e_loc, (grid.model_index + 1) * e_loc)
    return (frames[ts, grid.model_index * n_loc:
                   (grid.model_index + 1) * n_loc],
            edges[ts, es], ew[ts, es])


def partition_edges_for_hybrid(edges_padded, weights, masks,
                               num_nodes: int, pm: int,
                               max_local_edges: int):
    """Host-side: per snapshot, split edges into Pm dst-shards (dst LOCAL,
    src GLOBAL), stacked along the edge axis so spec P(data, model) shards
    correctly.  Returns (T, Pm*E_loc, 2) edges and matching weights."""
    t_steps = edges_padded.shape[0]
    n_per = num_nodes // pm
    out_e = np.zeros((t_steps, pm, max_local_edges, 2), dtype=np.int32)
    out_w = np.zeros((t_steps, pm, max_local_edges), dtype=np.float32)
    for t in range(t_steps):
        e = np.asarray(edges_padded[t])
        m = np.asarray(masks[t]) > 0
        ev = e[m]
        wv = np.asarray(weights[t])[m]
        owner = ev[:, 1] // n_per
        for p in range(pm):
            sel = ev[owner == p]
            ws = wv[owner == p]
            k = min(sel.shape[0], max_local_edges)
            out_e[t, p, :k, 0] = sel[:k, 0]
            out_e[t, p, :k, 1] = sel[:k, 1] % n_per
            out_w[t, p, :k] = ws[:k]
    return (out_e.reshape(t_steps, pm * max_local_edges, 2),
            out_w.reshape(t_steps, pm * max_local_edges))
