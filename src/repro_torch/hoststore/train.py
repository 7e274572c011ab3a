"""The sampled training schedule (``mode="sampled"``), on a process group
(port of ``repro.hoststore.train``).

Composes the pieces of this package with the EXISTING distributed round
step: ``make_sampled_step`` is ``stream.distributed.make_dist_stream_step``
instantiated on the round node TABLE (the model config's vertex axis
becomes ``table_pad``) with the seed-restricted loss — same Laplacian
preamble, same ``partition.snapshot_block_body`` (two all-to-alls per
layer over the table axis), same AdamW cadence.  One round per
checkpoint block, like every streamed schedule.

Between rounds the per-node temporal state lives in a
:class:`~repro_torch.hoststore.carry.HostCarryStore`.  The reference
keeps one full-N store in its one process; here every rank keeps its
own, and after a round a rank holds new carries only for its
``table_pad / P`` lanes, while the next round's table deals lanes to
ranks afresh.  So every rank's store takes every rank's post-round rows:
one all-gather of the round's carry rows over the group
(:func:`all_gather_carries`), then the same ``scatter`` on every rank,
which keeps the stores identical.  EvolveGCN's weight carry has no node
axis and is the same on every rank, so it is scattered as it is.

With full fanout and every vertex a seed this loop is numerically the
full-graph distributed stream (pinned at rtol 1e-5 in
``tests/test_torch_hoststore.py``); with truncated fanout it is
GraphSAGE-style stochastic training.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.core import models as mdl
from repro_torch.dist.sharding import all_gather, group_rank, group_size
from repro_torch.hoststore.carry import HostCarryStore, leaves, rebuild
from repro_torch.hoststore.sampled import (SampledSliceStream, SampleReport,
                                          worker_pool)
from repro_torch.hoststore.spec import ResolvedSampling, SamplingSpec
from repro_torch.hoststore.store import TemporalCSRStore
from repro_torch.optim import adamw
from repro_torch.stream import distributed as stream_dist
from repro_torch.stream.prefetch import PrefetchIterator, stage_item


@dataclass
class SampledState:
    params: mdl.ParamTree
    opt_state: dict
    losses: list
    report: SampleReport = field(default_factory=SampleReport)


def table_config(cfg: mdl.DynGNNConfig,
                 resolved: ResolvedSampling) -> mdl.DynGNNConfig:
    """The model config the sampled step runs against: the vertex axis
    is the round node table, everything else unchanged."""
    return dataclasses.replace(cfg, num_nodes=resolved.table_pad)


def make_sampled_step(cfg: mdl.DynGNNConfig, resolved: ResolvedSampling,
                      group, opt_cfg: adamw.AdamWConfig,
                      a2a_chunks: int = 1):
    """The sampled round step: the distributed stream step on the table
    axis with the seed-restricted loss."""
    return stream_dist.make_dist_stream_step(
        table_config(cfg, resolved), group, opt_cfg, a2a_chunks=a2a_chunks,
        num_seeds=resolved.num_seeds)


def all_gather_carries(carries: list, axis: int | None, group) -> list:
    """Every rank's post-round carry lanes, concatenated in rank order
    along the node axis -> the full table's carries on every rank (one
    all-gather a leaf).  Carries without a node axis are returned as
    they are."""
    if axis is None:
        return carries

    def gather(leaf):
        return all_gather(leaf, group).movedim(0, axis).flatten(axis,
                                                                axis + 1)

    return [rebuild(c, [gather(x) for x in leaves(c)])[0] for c in carries]


def train_sampled(cfg: mdl.DynGNNConfig, store: TemporalCSRStore,
                  frames: np.ndarray, labels: np.ndarray, *,
                  spec: SamplingSpec, mesh,
                  block_size: int | None = None, num_epochs: int = 1,
                  overlap: bool = True, prefetch_depth: int = 2,
                  a2a_chunks: int = 1,
                  opt_cfg: adamw.AdamWConfig | None = None,
                  params: mdl.ParamTree | None = None, opt_state=None,
                  step_fn=None, carry_store: HostCarryStore | None = None,
                  report: SampleReport | None = None, seed: int = 0,
                  log_every: int = 10, log_fn=None,
                  device: str | torch.device = "cuda") -> SampledState:
    """Out-of-core sampled training over the host-resident store, as this
    rank of the process group ``mesh``.

    The device never sees the full graph: per round it receives its
    slice of the sampled subgraph tensors (``SampledSliceStream``,
    prefetch-staged on a side stream when ``overlap``) plus its lanes of
    the table rows of the host-resident carries, and every rank's store
    takes the updated rows of every lane.  ``params`` (a ``ParamTree``,
    moved to ``device`` and updated in place) default to
    ``mdl.init_params`` from ``seed``; ``step_fn`` / ``carry_store`` /
    ``report`` let the Engine worker reuse them across calls; the steps
    are expanded in the process's shared sampling pool
    (``sampled.worker_pool``), started by the first fit.  Each
    round runs in a ``round`` stopwatch, with ``carry.gather``,
    ``round.step``, ``carry.all_gather`` and ``carry.scatter`` spans
    (fenced when tracing fences) inside it.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    t_steps = store.num_steps
    num_procs, rank = group_size(mesh), group_rank(mesh)
    win = block_size or max(t_steps // max(cfg.checkpoint_blocks, 1), 1)
    if win % num_procs:
        raise ValueError(f"block_size {win} must divide into {num_procs} "
                         "shards")
    if t_steps % win:
        raise ValueError(f"trace length {t_steps} must be a multiple of "
                         f"block_size {win}")
    resolved = spec.resolve(cfg.num_nodes, win, num_procs)
    opt_cfg = opt_cfg or adamw.AdamWConfig(
        lr=1e-2, warmup_steps=10, total_steps=num_epochs * t_steps,
        weight_decay=0.0)
    if params is None:
        params = mdl.init_params(torch.Generator().manual_seed(seed), cfg)
    params = params.to(dev)
    if opt_state is None:
        opt_state = adamw.init_state(params)
    if step_fn is None:
        step_fn = make_sampled_step(cfg, resolved, mesh, opt_cfg,
                                    a2a_chunks=a2a_chunks)
    if carry_store is None:
        # sized by the GLOBAL cfg (full-N resident rows); gather() pads
        # each round's table rows up to table_pad for the device step
        carry_store = HostCarryStore(cfg, params)
    report = report if report is not None else SampleReport()
    stream = SampledSliceStream(store=store, frames=frames, labels=labels,
                                spec=spec, resolved=resolved, win=win,
                                rank=rank, num_shards=num_procs, device=dev,
                                pool=worker_pool(spec.workers))
    axis = carry_store.axis
    # this rank's table lanes (its vertex block of the step's temporal
    # stage); past the table's fill, gather() pads them with zeros
    lane_count = resolved.table_pad // num_procs
    lanes = slice(rank * lane_count, (rank + 1) * lane_count)

    losses: list[float] = []

    def emit(loss: torch.Tensor) -> None:
        losses.append(loss.item())
        if log_fn is not None and (len(losses) - 1) % log_every == 0:
            log_fn(f"sampled round {len(losses) - 1} loss "
                   f"{losses[-1]:.4f} (P={num_procs}, win={win}, "
                   f"table={resolved.table_pad}, "
                   f"seeds={resolved.num_seeds})")

    try:
        for epoch in range(num_epochs):
            carry_store.reset(params)    # epoch-start semantics: fresh state
            host = stream.rounds(epoch)
            if overlap:
                rounds = PrefetchIterator(host, stage_fn=stream.stage_fn(),
                                          depth=prefetch_depth, device=dev)
            else:
                stage = stream.stage_fn()
                rounds = (stage(x) for x in host)
            try:
                for staged in rounds:
                    # carries CANNOT prefetch: round r's gather depends on
                    # round r-1's scatter (the host-resident state is the
                    # cross-round data dependency)
                    with obs.stopwatch("round", cat="round", round=staged.r,
                                       epoch=epoch, schedule="sampled") as sw:
                        stream.receive(staged)
                        with obs.span("carry.gather", round=staged.r) as sp:
                            host_carries = carry_store.gather(
                                staged.node_ids[lanes], lane_count)
                            carries = [stage_item(c, dev)
                                       for c in host_carries]
                            sp.fence(carries)
                        staged.staged_bytes += sum(
                            leaf.nbytes for c in host_carries
                            for leaf in leaves(c))
                        with obs.span("round.step", round=staged.r) as sp:
                            params, opt_state, new_carries, _, loss = \
                                step_fn(params, opt_state, carries, None,
                                        staged.frames, staged.edges,
                                        staged.mask, staged.values,
                                        staged.labels, staged.t0)
                            sp.fence(loss)
                        with obs.span("carry.all_gather",
                                      round=staged.r) as sp:
                            full = all_gather_carries(new_carries, axis, mesh)
                            sp.fence(full)
                        with obs.span("carry.scatter", round=staged.r):
                            carry_store.scatter(staged.node_ids, full)
                        emit(loss)
                    report.fold(staged)
                    report.step_seconds += sw.seconds
            finally:
                if isinstance(rounds, PrefetchIterator):
                    rounds.close()
    finally:
        stream.close()
    return SampledState(params=params, opt_state=opt_state, losses=losses,
                        report=report)
