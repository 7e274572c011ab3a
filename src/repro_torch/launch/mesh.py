"""Grids of ranks for the cells (port of ``repro.launch.mesh``).

The reference builds a ``jax.sharding.Mesh`` over the devices of one
process; the port runs one process per rank, so a mesh is a
``dist.sharding.Grid`` of process groups (rank r at data index
``r // model`` and model index ``r % model``, as the reference places its
devices).

* :func:`make_host_mesh` -- a ``data x model`` grid over the default
  process group, or over ``group``;
* :func:`join_one_rank` -- a one-rank process group of this process when
  none is open (NCCL on ``cuda:0``, gloo on the CPU; an in-memory store,
  no port), the group a cell on one card runs over;
* :func:`join_world` -- the process group ``torchrun`` describes in the
  environment, or a one-rank group of this process without it;
* :func:`mesh_device_count` -- the number of ranks of a grid.

``make_production_mesh`` (the TPU pods of 256 and 512 chips, 16 x 16 and
2 x 16 x 16) has no counterpart: the machine the port runs on has one
card.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.dist.sharding import Grid, make_grid


def make_host_mesh(data: int = 1, model: int = 1, group=None) -> Grid:
    """A ``data x model`` grid over ``group`` (default: the world).  Raises
    when no process group is open or when ``data * model`` differs from
    the group's size, as the reference raises when its devices are too
    few."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh: no process group is open "
                           "(torch.distributed.init_process_group, or "
                           "join_one_rank for one process)")
    n = dist.get_world_size(group)
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, "
                         f"the process group has {n}")
    return make_grid(data, model, group)


def join_one_rank(device: str | torch.device = "cuda") -> Grid:
    """Open a one-rank process group of this process (NCCL with
    ``cuda:0`` for a card, gloo for the CPU) unless one is open, and
    return its 1 x 1 grid.  The caller ends the group
    (``dist.destroy_process_group``)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        alone = {"store": dist.HashStore(), "rank": 0, "world_size": 1}
        if dev.type == "cuda":
            dist.init_process_group("nccl", device_id=torch.device(
                "cuda", dev.index or 0), **alone)
        else:
            dist.init_process_group("gloo", **alone)
    return make_host_mesh(1, 1)


def join_world(device: str | torch.device = "cuda") -> bool:
    """Join the process group ``torchrun`` describes in the environment
    (``WORLD_SIZE`` ranks), or a one-rank group of this process when it
    describes none: gloo on the CPU, NCCL with this rank on
    ``cuda:LOCAL_RANK``.  Returns False, joining nothing, when a group is
    already open; True when it opened one, which the caller then ends
    (``dist.destroy_process_group``)."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return False
    alone = ({"store": dist.HashStore(), "rank": 0, "world_size": 1}
             if int(os.environ.get("WORLD_SIZE", "1")) == 1 else {})
    if dev.type == "cpu":
        dist.init_process_group("gloo", **alone)
        return True
    local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", device_id=local, **alone)
    return True


def mesh_device_count(grid: Grid) -> int:
    """Ranks in the grid (the reference: devices in the mesh)."""
    return grid.pd * grid.pm
