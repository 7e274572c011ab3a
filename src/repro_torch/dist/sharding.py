"""Process-group rank layout and the counted all-to-alls of snapshot
partitioning (paper §4.2, Fig. 3b).

Port of the snapshot-partitioning part of ``repro.dist.sharding`` (its LM
and DIN spec trees wait for ROADMAP Queue 1, item 9d-2).  The reference runs
P devices in one process under ``shard_map`` over the mesh axis
``"data"``; the port runs one process per rank in a ``torch.distributed``
process group — gloo on the CPU, NCCL on the card with rank r on
``cuda:r`` — and the group plays the mesh's part.  A group is
one-dimensional, so its one axis is :data:`DATA_AXIS`.  The hybrid scheme
(paper §6.5) needs the reference's 2-D ``(data, model)`` mesh: a
:class:`Grid` of subgroups (:func:`make_grid`) plays it.

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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

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


@dataclass(frozen=True)
class Grid:
    """This rank's place in a ``pd x pm`` grid of ranks, the reference's
    ``make_host_mesh(data=pd, model=pm)``: rank r sits at data index
    ``r // pm`` and model index ``r % pm`` (its mesh device), so its
    shard of a ``P(data, model, None)`` array is block ``(r // pm, r %
    pm)``.  ``data`` is the rank's grid column (the pd ranks of its model
    index: the snapshot all-to-alls run over it), ``model`` its grid row
    (the pm ranks of its data index: the vertex all-gather and the
    ``hybrid_spmm`` all-reduce run over it)."""

    pd: int
    pm: int
    rank: int
    data: Any
    model: Any

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
    return Grid(pd, pm, rank, columns[rank % pm], rows[rank // pm])


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
