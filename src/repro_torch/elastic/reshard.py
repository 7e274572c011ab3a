"""Moving a live run onto a new width (port of ``repro.elastic.reshard``).

The reference re-lays its arrays onto a new mesh with one
``jax.device_put`` per leaf.  Here a width-p group is ranks ``0..p-1`` of
the run's pool of processes (``width_groups``), and a rescale moves, over
``torch.distributed``:

* **temporal carries** — the only block-boundary activations (paper
  §3.1's ``pi_b``).  They live vertex-sharded, N/P rows a rank
  (EvolveGCN's weight carry whole on every rank).  The old group
  all-gathers them (``gather_carries``), rank 0 broadcasts the full-N
  tree over the pool, and each rank of the new group keeps its N/P'
  rows (``slice_carries``).  Carries restored from a checkpoint are
  already full-N host arrays and are sliced the same way;
* **train state** — params + AdamW state are replicated, so a growing
  run broadcasts rank 0's over the pool (``broadcast_state``) and a
  shrinking one moves nothing (the survivors hold them).

``rescale_payload_bytes`` is the measured-tree instantiation of the
analytic ``dist.comm_volume.rescale_payload``, on the FULL carry tree
(what the reference's trees hold): the ``RescaleEvent`` records what the
model predicts, not what the wire carried.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import models as mdl
from repro_torch.dist import comm_volume as cv
from repro_torch.dist.sharding import all_gather, group_rank, group_size

_GROUPS: dict = {}


def width_groups(widths, pool) -> dict:
    """``{p: the group of the pool's first p ranks}`` for every width.
    ``dist.new_group`` is collective over the whole world, so every rank
    creates every width's group, in one (sorted) order, including those
    it is not in; a width spanning the pool is the pool itself.  Groups
    are made once a process and reused by later runs."""
    ranks = dist.get_process_group_ranks(pool)
    out = {}
    for p in sorted(set(widths)):
        if not 1 <= p <= len(ranks):
            raise ValueError(f"width {p} outside the pool's {len(ranks)} "
                             "ranks")
        if p == len(ranks):
            out[p] = pool
            continue
        key = (id(pool), p)
        if key not in _GROUPS or _GROUPS[key][0] is not pool:
            _GROUPS[key] = (pool, dist.new_group(ranks[:p]))
        out[p] = _GROUPS[key][1]
    return out


def drop_width_groups() -> None:
    """Forget every cached width group.  Call it before
    ``dist.destroy_process_group()``: a group the cache kept alive past
    that teardown is destroyed at interpreter exit instead, where gloo can
    abort a process whose run succeeded (``terminate called without an
    active exception``, exit -6)."""
    _GROUPS.clear()


def tree_bytes(tree) -> int:
    """Total bytes of every tensor leaf in ``tree`` (0 for None): a
    ``ParamTree``, a dict, or nested lists / tuples of tensors."""
    if tree is None:
        return 0
    if isinstance(tree, torch.nn.Module):
        return int(sum(p.nbytes for p in tree.parameters()))
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return int(tree.nbytes)


def rescale_payload_bytes(params, opt_state, full_carries, old_p: int,
                          new_p: int) -> int:
    """Bytes one P_old -> P_new rescale moves by the reference's law,
    from the live trees (``full_carries``: the full-N carry tree, None at
    an epoch boundary)."""
    carry_b = tree_bytes(full_carries)
    state_b = tree_bytes(params) + tree_bytes(opt_state)
    return int(cv.rescale_payload(carry_b, state_b, old_p, new_p))


def carry_axes(cfg: mdl.DynGNNConfig) -> list:
    """The vertex axis of each carry leaf (None: replicated), mirroring
    ``models.init_carries``: CD-GCN's LSTM (h, c) rows, TM-GCN's (w-1,
    N, d) window, EvolveGCN's weight carry whole."""
    one = {"cdgcn": (0, 0), "evolvegcn": (None, (None, None)),
           "tmgcn": 1}[cfg.model]
    return [one] * cfg.num_layers


def _map(fn, tree, axes):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t, a)
                          for t, a in zip(tree, axes, strict=True))
    return fn(tree, axes)


def gather_carries(cfg: mdl.DynGNNConfig, carries, group) -> list:
    """This rank's N/P-row carries -> the full-N tree on every rank of
    ``group`` (one all-gather a vertex-sharded leaf)."""
    def full(x, axis):
        if axis is None:
            return x.clone()
        parts = all_gather(x, group)            # (P, *x.shape)
        return torch.cat(list(parts.unbind(0)), dim=axis)

    return _map(full, carries, carry_axes(cfg))


def slice_carries(cfg: mdl.DynGNNConfig, full, p: int, rank: int,
                  device=None) -> list:
    """Rank ``rank``'s N/p rows of a full-N carry tree (host arrays or
    tensors), as contiguous tensors on ``device``."""
    n_loc = cfg.num_nodes // p

    def take(x, axis):
        x = torch.as_tensor(x)
        if axis is not None:
            x = x.narrow(axis, rank * n_loc, n_loc)
        return x.to(device).contiguous().clone()

    return _map(take, full, carry_axes(cfg))


def broadcast_full_carries(cfg: mdl.DynGNNConfig, params, full, pool,
                           device) -> list:
    """Rank 0's full-N carry tree on every rank of ``pool`` (``full`` is
    read on rank 0 only; the others receive into zeros of its shape)."""
    mine = full if group_rank(pool) == 0 else mdl.init_carries(
        cfg, params, device=device)

    def bcast(x, _axis):
        x = x.detach().clone().to(device)
        dist.broadcast(x, src=dist.get_global_rank(pool, 0), group=pool)
        return x

    return _map(bcast, mine, carry_axes(cfg))


def broadcast_state(params, opt_state: dict, pool):
    """Rank 0's params and AdamW state on every rank of ``pool`` (in
    place for the parameters; the host step counter travels on the
    parameters' device)."""
    src = dist.get_global_rank(pool, 0)
    dev = next(params.parameters()).device
    with torch.no_grad():
        for p in params.parameters():
            dist.broadcast(p.data, src=src, group=pool)
    for key in ("m", "v", "master"):
        for t in opt_state[key].values():
            dist.broadcast(t, src=src, group=pool)
    step = opt_state["step"].to(dev, torch.int64)
    dist.broadcast(step, src=src, group=pool)
    opt_state["step"] = step.to(opt_state["step"].device, torch.int32)
    return params, opt_state


