"""Process-group rank layout and the counted all-to-alls of snapshot
partitioning (paper §4.2, Fig. 3b).

Port of the snapshot-partitioning part of ``repro.dist.sharding`` (its LM
and DIN spec trees wait for ROADMAP Queue 1, item 9).  The reference runs
P devices in one process under ``shard_map`` over the mesh axis
``"data"``; the port runs one process per rank in a ``torch.distributed``
process group — gloo on the CPU, NCCL on the card with rank r on
``cuda:r`` — and the group plays the mesh's part.  A group is
one-dimensional, so its one axis is :data:`DATA_AXIS`.

* :class:`ShardLayout` — which steps and vertices a rank owns: inside
  every checkpoint block of ``bsize`` steps, rank p owns the ``bsl =
  bsize / P`` contiguous steps from ``p * bsl`` (time-sharded domain),
  and the vertices ``p * N/P ... (p + 1) * N/P - 1`` (vertex-sharded
  domain, where the temporal stage runs).
* :class:`AllToAll` — ``dist.all_to_all_single`` with equal splits as an
  autograd function.  The adjoint of an equal-split all-to-all is the
  same all-to-all, so its backward sends the gradient the same way.
* :func:`t_to_n` / :func:`n_to_t` — the two redistributions of a layer,
  laid out as ``jax.lax.all_to_all(..., tiled=True)`` lays them out.

Every all-to-all, forward or backward, adds to three ``obs`` counters:
``partition.a2a_calls``, ``partition.a2a_bytes`` (the bytes this rank
hands to the collective) and ``partition.a2a_remote_bytes`` (the
(P - 1) / P of them that leave the rank).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch import obs

#: the one axis of a process group: the snapshot-parallel (data) axis
DATA_AXIS = "data"


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


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
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
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def t_to_n(h: torch.Tensor, group) -> torch.Tensor:
    """Time-sharded (bsl, N, F) -> vertex-sharded (P bsl, N/P, F).

    Rank p sends vertex block q of its steps to rank q and receives its
    own vertex block of every rank's steps, stacked by source rank, which
    is time order (rank q owns steps q bsl ... of the block).  At P = 1
    the permuted view is already contiguous, so nothing is copied; the
    collective is issued all the same."""
    p = group_size(group)
    bsl, n, f = h.shape
    x = h.reshape(bsl, p, n // p, f).permute(1, 0, 2, 3)
    return AllToAll.apply(x, group).reshape(p * bsl, n // p, f)


def n_to_t(h: torch.Tensor, group) -> torch.Tensor:
    """Vertex-sharded (bsize, N/P, F) -> time-sharded (bsize/P, N, F):
    the inverse of :func:`t_to_n`."""
    p = group_size(group)
    bsize, n_loc, f = h.shape
    x = h.reshape(p, bsize // p, n_loc, f)
    y = AllToAll.apply(x, group)           # (source rank = vertex block)
    return y.permute(1, 0, 2, 3).reshape(bsize // p, p * n_loc, f)
