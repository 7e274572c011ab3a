"""The paper's §6.4 comparison in miniature, on the port: the same model's
loss under snapshot partitioning and on one device (identical, Fig. 6),
then the comm-volume law (Table 2).

The twin of ``examples/partition_compare.py``.  The reference partitions
over P = min(4, devices) devices of one process; here P = min(4, ranks)
of a ``torch.distributed`` group, one process a rank (gloo on the CPU,
NCCL with one card a rank).  Alone it joins a one-rank group:

  torchrun --standalone --nproc-per-node 4 \
      examples/torch/partition_compare.py [--device cpu]
  PYTHONPATH=src python examples/torch/partition_compare.py [--device cpu]

Rank 0 prints.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core import checkpoint as ckpt_exec
from repro_torch.core import dtdg, models, partition
from repro_torch.dist import comm_volume as cv
from repro_torch.dist.sharding import ShardLayout
from repro_torch.graph import generate
from repro_torch.launch import mesh
from repro_torch.run import ExecutionPlan

N, T, NB = 128, 16, 2


def volume_table() -> list[tuple]:
    """Table 2's rows at T = 64, N = 4,096, F = 6, L = 2: (P, snapshot,
    hypergraph, allgather) volumes in float units."""
    snaps_big = generate.evolving_dynamic_graph(4096, 16, 4.0, 0.15, 0)
    owner_edges = np.concatenate(snaps_big)
    rows = []
    for pp in (4, 16, 64):
        v_s = cv.snapshot_partition_volume(64, 4096, 6, 2, pp)
        owner = cv.bfs_partition(owner_edges, 4096, pp)
        v_h = cv.vertex_partition_volume(snaps_big, 4096, 6, 2, pp, owner) \
            * 4  # scale 16 -> 64 steps
        v_a = cv.allgather_vertex_volume(64, 4096, 6, 2, pp)
        rows.append((pp, v_s, v_h, v_a))
    return rows


def losses(group, dev: torch.device, params=None) -> tuple[float, float]:
    """(snapshot-partitioned, one-device) loss of the miniature TM-GCN on
    this rank of ``group``; ``params`` drawn from seed 0 by the port when
    None."""
    snaps = generate.evolving_dynamic_graph(N, T, density=3.0, churn=0.1,
                                            seed=0)
    frames = np.stack([generate.degree_features(s, N) for s in snaps])
    batch = dtdg.build_batch(snaps, frames, N, device=dev)
    labels = torch.from_numpy((frames[:, :, 0] > np.median(
        frames[:, :, 0])).astype(np.int32)).to(dev)
    cfg = models.DynGNNConfig(model="tmgcn", num_nodes=N, num_steps=T,
                              window=3, checkpoint_blocks=NB)
    if params is None:
        params = models.init_params(torch.Generator().manual_seed(0), cfg)
    params = params.to(dev)

    # identical losses under both schemes (paper Fig. 6)
    layout = ShardLayout.of(group, NB, T // NB, N)
    fr, ed, ew = (layout.local(a)
                  for a in partition.blockify_batch(batch, NB))
    lab_b = layout.local(labels.reshape(NB, T // NB, N))
    with torch.no_grad():
        l_sp = partition.snapshot_partition_loss(cfg, group)(
            params, fr, ed, ew, lab_b)
        dist.all_reduce(l_sp, group=group)   # the ranks' shares sum to it
        l_ref = ckpt_exec.blocked_node_loss(cfg, params, batch, labels,
                                            nb=NB)
    return float(l_sp), float(l_ref)


def run(device: str = "cuda", params=None, echo=print) -> dict | None:
    """Join (or take) the process group, compute both losses over its
    first min(4, ranks) ranks, print the example's lines on rank 0 through
    ``echo`` and return their numbers there (None on other ranks).
    ``params``: a ``ParamTree``; drawn from seed 0 by the port when None.
    A group this function opened is ended before it returns."""
    dev = resolve_device(device)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    p = min(4, world)
    if (T // NB) % p:
        raise ValueError(f"{p} ranks: the {T // NB} steps of a block must "
                         "split evenly over them")
    ExecutionPlan(shards=world).check_devices(dev)   # NCCL: a card a rank
    opened = mesh.join_world(dev)
    sub = None
    try:
        group = dist.group.WORLD
        if p < world:
            sub = group = dist.new_group(list(range(p)))
        rank = dist.get_rank()
        if rank >= p:
            return None
        l_sp, l_ref = losses(group, dev, params)
        if rank:
            return None
        echo(f"loss  snapshot-partitioned: {l_sp:.6f}")
        echo(f"loss  single-device ref  : {l_ref:.6f}")
        same = bool(np.allclose(l_sp, l_ref, atol=1e-6))
        echo(f"identical: {same}")

        # comm volume law (Table 2)
        echo("\ncomm volume (float units), T=64 N=4096 F=6 L=2:")
        echo(f"{'P':>4s} {'snapshot':>12s} {'hypergraph':>12s} "
             f"{'allgather':>12s}")
        rows = volume_table()
        for pp, v_s, v_h, v_a in rows:
            echo(f"{pp:4d} {v_s:12.3e} {v_h:12.3e} {v_a:12.3e}")
        echo("\nsnapshot volume is ~constant in P; vertex volume grows with "
             "P (the paper's central claim).")
        return {"p": p, "loss_sp": l_sp, "loss_ref": l_ref,
                "identical": same, "volume": rows}
    finally:
        if opened:
            dist.destroy_process_group()
        elif sub is not None:
            dist.destroy_process_group(sub)


def main(argv: list[str] | None = None) -> dict | None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
