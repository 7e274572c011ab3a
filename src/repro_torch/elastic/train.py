"""Mid-run recomposition of the distributed stream (port of
``repro.elastic.train``).

``train_elastic_streamed`` drives the per-round protocol of
``stream.distributed.train_distributed_streamed`` in SEGMENTS of constant
snapshot-parallel width, round for round as the reference does.  The
run's processes form a POOL of ``max(widths)`` ranks (the world, or the
plan's group when its width never changes); width p trains on the group
of the pool's first p ranks (``reshard.width_groups``, every group
created at start-up in one order), and the ranks outside it wait at the
next boundary and compute nothing.  At every checkpoint-block boundary
the :class:`~repro_torch.elastic.controller.RescaleController` says what
width the next block trains under; when the answer changes the loop

1. gathers the temporal carries over the old group, broadcasts them over
   the pool and keeps each new rank's N/P' rows, and (growing)
   broadcasts rank 0's params + AdamW state (``reshard``; bytes by
   ``dist.comm_volume.rescale_payload``),
2. encodes this rank's stream for the new width once (a later boundary
   slices it: ``ElasticRuntime.shard_stream``),
3. records a :class:`RescaleEvent` on the run's ``RescaleReport``.

After every segment the pool agrees in one all-reduce on what the active
ranks did (rank 0's losses and stream bytes) and on the preemption flag:
a SIGTERM may reach one rank, so each rank's ``PreemptionGuard`` flag is
folded into one agreed view that every rank's controller reads — the
ranks never disagree on a width or on stopping.  Inside a segment the
stop decision is agreed round by round
(``train_distributed_streamed``'s ``stop_fn``).

Rescaling is schedule, not math: each block is one mean-CE AdamW step
over ``win`` snapshots whatever P computes it, so the loss stream under
any width trajectory stays pinned to the serial single-device reference
(``tests/test_torch_elastic.py``).  Checkpointing rides on the same
boundaries: every ``ckpt_every`` rounds (and on an unabsorbed SIGTERM,
blocking) rank 0 saves params / opt / the full-N carries plus the data
cursor, and a restored run continues from that cursor on any legal
width.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repro_torch import obs, resolve_device
from repro_torch.core import models as mdl
from repro_torch.dist.sharding import group_rank, group_size
from repro_torch.elastic import reshard
from repro_torch.elastic.controller import (RescaleController, RescaleEvent,
                                            RescaleReport)
from repro_torch.ft.straggler import StepTimer
from repro_torch.optim import adamw
from repro_torch.stream import distributed as sdist
from repro_torch.stream import encoder as enc
from repro_torch.stream import sharded as stream_sharded
from repro_torch.stream import train_loop as tl


class ElasticRuntime:
    """Caches that survive rescale events and repeated fits: the width
    groups (all made at construction), and per width this rank's step and
    its encoded stream.  A stream is encoded ONCE from block 0 the first
    time the rank trains at that width; a from-boundary request slices
    it (see ``shard_stream``), and that first encode is the cost a
    ``RescaleEvent.recompose_s`` measures."""

    def __init__(self, cfg, opt_cfg, widths, pool, a2a_chunks: int = 1):
        self.cfg, self.opt_cfg, self.a2a_chunks = cfg, opt_cfg, a2a_chunks
        self.pool = pool
        self.rank = group_rank(pool)
        self.groups = reshard.width_groups(widths, pool)
        self.steps: dict = {}
        self.streams: dict = {}

    def step(self, p: int):
        if p not in self.steps:
            self.steps[p] = sdist.make_dist_stream_step(
                self.cfg, self.groups[p], self.opt_cfg,
                a2a_chunks=self.a2a_chunks)
        return self.steps[p]

    def shard_stream(self, p: int, start_block: int, snapshots, values,
                     max_edges: int, win: int, stats):
        """This rank's stream at width ``p`` from ``start_block`` on.

        The from-boundary encoding equals the tail of the from-zero one
        (every block slice opens with a self-contained ``FullSnapshot``;
        pinned by ``tests/test_torch_elastic.py``), so a boundary request
        is a list slice of the cached encoding."""
        if p not in self.streams:
            self.streams[p] = stream_sharded.encode_time_sliced(
                snapshots, values, self.cfg.num_nodes, max_edges, win, p,
                stats, shards=[self.rank])[0]
        return self.streams[p][start_block * (win // p):]


@dataclass
class ElasticStreamState:
    """What the elastic loop hands back to the Engine worker (the same
    on every rank of the pool, but ``carries``: this rank's rows)."""

    params: mdl.ParamTree
    opt_state: dict
    losses: list
    report: RescaleReport
    cursor: int             # global rounds completed == resume point
    completed: bool         # False = preempted (checkpointed, resumable)
    carries: object = field(default=None, repr=False)


def validate_widths(widths, win: int, num_nodes: int,
                    num_devices: int) -> None:
    """Every width a rescale policy can ask for must be realizable: fit
    the pool's ranks (``num_devices``), divide the block (each round is
    sliced over the shards) and the vertex axis (N-sharded temporal
    stage).  The one rule set — ``Engine.resolve`` and the elastic loop
    both call it."""
    for p in widths:
        if p < 1:
            raise ValueError(f"rescale width must be >= 1, got {p}")
        if p > num_devices:
            raise ValueError(f"rescale width {p} exceeds the {num_devices} "
                             "attached devices")
        if win % p:
            raise ValueError(f"rescale width {p} does not divide the "
                             f"checkpoint block size {win}")
        if num_nodes % p:
            raise ValueError(f"rescale width {p} does not divide num_nodes "
                             f"{num_nodes} (vertex-sharded temporal "
                             "stage); pad the vertex axis")


class _AgreedFlag:
    """The preemption flag as the pool agreed it: what the controller
    reads in place of one process's ``PreemptionGuard``."""

    preempted = False


def train_elastic_streamed(cfg: mdl.DynGNNConfig, snapshots, values, frames,
                           labels, *, controller: RescaleController,
                           pool=None, block_size: int | None = None,
                           num_epochs: int = 1, overlap: bool = True,
                           prefetch_depth: int = 2, a2a_chunks: int = 1,
                           pipeline_rounds: bool = False,
                           opt_cfg: adamw.AdamWConfig | None = None,
                           params: mdl.ParamTree | None = None,
                           opt_state=None,
                           stats: enc.DeltaStats | None = None,
                           max_edges: int | None = None,
                           runtime: ElasticRuntime | None = None,
                           ckpt=None, ckpt_every: int = 0,
                           start_cursor: int = 0, carries=None,
                           seed: int = 0, log_every: int = 10,
                           log_fn=None,
                           device: str | torch.device = "cuda"
                           ) -> ElasticStreamState:
    """Distributed streamed training whose width P may change mid-run,
    on every rank of ``pool`` (default: the world; ``runtime.pool`` when
    a runtime is given).

    Semantics are those of ``train_distributed_streamed`` round for
    round; the controller only decides WHICH group computes each block.
    ``start_cursor`` / ``carries`` resume a checkpointed run (global round
    cursor; ``carries`` the full-N tree the checkpoint holds, sliced for
    each rank here).  ``ckpt`` / ``ckpt_every`` enable round-granular
    checkpointing (a ``repro_torch.ckpt.Checkpointer``, written by rank
    0; 0 = only on preemption).
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    t_steps = len(snapshots)
    win = block_size or max(t_steps // max(cfg.checkpoint_blocks, 1), 1)
    if t_steps % win:
        raise ValueError(f"trace length {t_steps} must be a multiple of "
                         f"block_size {win}")
    rpe = t_steps // win                    # rounds (blocks) per epoch
    total = num_epochs * rpe
    if not 0 <= start_cursor <= total:
        raise ValueError(f"start_cursor {start_cursor} outside the run's "
                         f"{total} rounds")
    max_edges = max_edges or tl.default_max_edges(snapshots)
    if stats is None:
        stats = enc.measure_stats(snapshots, cfg.num_nodes, win, max_edges)
    opt_cfg = opt_cfg or adamw.AdamWConfig(
        lr=1e-2, warmup_steps=10, total_steps=num_epochs * t_steps,
        weight_decay=0.0)
    if params is None:
        params = mdl.init_params(torch.Generator().manual_seed(seed), cfg)
    params = params.to(dev)
    if opt_state is None:
        opt_state = adamw.init_state(params)
    if runtime is not None:
        pool = runtime.pool
    elif pool is None:
        pool = dist.group.WORLD
    pool_n, rank = group_size(pool), group_rank(pool)
    validate_widths(set(controller.widths), win, cfg.num_nodes, pool_n)
    rt = runtime or ElasticRuntime(cfg, opt_cfg, controller.widths, pool,
                                   a2a_chunks)

    report = RescaleReport(resumed_from=start_cursor or None)
    losses: list[float] = []
    completed = True
    p = controller.initial_p
    r = start_cursor
    full = carries          # full-N carries waiting to be sliced (resume)
    local = None            # this rank's N/P rows; None = fresh zeros
    live = False            # the active ranks hold this epoch's carries
    # one EWMA watchdog across every segment (reset at each rescale)
    timer = StepTimer()
    guard = controller.guard
    view = _AgreedFlag() if guard is not None else None

    def local_flag() -> bool:
        """This process's SIGTERM, consumed into the next agreement."""
        if guard is None or not guard.preempted:
            return False
        guard.preempted = False
        return True

    def agree_flag() -> None:
        if view is not None and sdist.agreed(local_flag(), pool, dev):
            view.preempted = True

    def save(blocking: bool = False) -> None:
        if ckpt is None or rank >= p:
            return
        tree_c = (reshard.gather_carries(cfg, local, rt.groups[p])
                  if live else mdl.init_carries(cfg, params))
        if rank == 0:
            ckpt.save(r, {"params": params, "opt": opt_state,
                          "carries": tree_c},
                      extra={"cursor": r, "p": p, "rounds_per_epoch": rpe},
                      blocking=blocking)

    controller.guard = view
    try:
        while r < total:
            agree_flag()
            epoch, rb = divmod(r, rpe)
            if rb == 0 and r != start_cursor:
                local = full = None         # epoch boundary: fresh carries
                live = False
            new_p, cause = controller.width_at(r, p)
            if new_p != p:
                with obs.stopwatch("elastic.rescale", cat="elastic",
                                   block=r, old_p=p, new_p=new_p,
                                   cause=cause) as sw:
                    if full is None and live:
                        mine = (reshard.gather_carries(cfg, local,
                                                       rt.groups[p])
                                if rank < p else None)
                        full = reshard.broadcast_full_carries(
                            cfg, params, mine, pool, dev)
                    payload = reshard.rescale_payload_bytes(
                        params, opt_state, full, p, new_p)
                    if new_p > p:
                        reshard.broadcast_state(params, opt_state, pool)
                    local = (reshard.slice_carries(cfg, full, new_p, rank,
                                                   dev)
                             if full is not None and rank < new_p else None)
                    live, full = full is not None, None
                    # the recompose covers this width's stream encode
                    # (once per width a rank joins) and the re-shard
                    if rank < new_p:
                        rt.shard_stream(new_p, rb, snapshots, values,
                                        max_edges, win, stats)
                dt = sw.seconds
                report.events.append(RescaleEvent(
                    block=r, old_p=p, new_p=new_p, payload_bytes=payload,
                    recompose_s=dt, cause=cause))
                obs.inc("elastic.rescales")
                obs.inc("elastic.payload_bytes", payload)
                # the expected round time changes with the width: restart
                # the EWMA so the watchdog re-seeds on the new pace
                timer.reset()
                if log_fn is not None:
                    log_fn(f"elastic: rescale P {p} -> {new_p} at block {r} "
                           f"({cause}; payload {payload} B, recompose "
                           f"{dt * 1e3:.1f} ms)")
                p = new_p
            elif full is not None:
                # resume: the checkpoint's full-N carries, this rank's rows
                local = (reshard.slice_carries(cfg, full, p, rank, dev)
                         if rank < p else None)
                live, full = True, None

            # segment end: next scripted boundary / epoch end / ckpt tick
            seg_end = (epoch + 1) * rpe
            nxt = controller.next_boundary(r)
            if nxt is not None:
                seg_end = min(seg_end, nxt)
            if ckpt is not None and ckpt_every:
                seg_end = min(seg_end,
                              ((r // ckpt_every) + 1) * ckpt_every)
            n_seg = seg_end - r
            # [rounds run, SIGTERMs, rank 0's losses, the shards' bytes]
            done = torch.zeros(2 + n_seg + p, dtype=torch.float64,
                               device=dev)
            if rank < p:
                stream = rt.shard_stream(p, rb, snapshots, values,
                                         max_edges, win, stats)
                st = sdist.train_distributed_streamed(
                    cfg, snapshots, values, frames, labels,
                    mesh=rt.groups[p], block_size=win, num_epochs=1,
                    overlap=overlap, prefetch_depth=prefetch_depth,
                    a2a_chunks=a2a_chunks, pipeline_rounds=pipeline_rounds,
                    opt_cfg=opt_cfg, params=params, opt_state=opt_state,
                    stats=stats, max_edges=max_edges, step_fn=rt.step(p),
                    seed=seed, shard_stream=stream[:n_seg * (win // p)],
                    start_round=rb, carries=local,
                    stop_fn=((lambda _blk: view.preempted
                              or guard.preempted)
                             if guard is not None else None),
                    log_every=log_every, log_fn=log_fn, step_timer=timer,
                    device=dev)
                params, opt_state, local = st.params, st.opt_state, \
                    st.carries
                if rank == 0:
                    done[0] = len(st.losses)
                    done[2:2 + len(st.losses)] = torch.tensor(
                        st.losses, dtype=torch.float64)
                    done[2 + n_seg:] = torch.tensor(st.per_shard_bytes,
                                                    dtype=torch.float64)
            done[1] = float(local_flag())
            dist.all_reduce(done, group=pool)
            got = done.cpu().numpy()
            count = int(got[0])
            if view is not None and got[1] > 0:
                view.preempted = True
            report.segments.append((r, p, [int(b) for b in got[2 + n_seg:]]))
            losses.extend(float(x) for x in got[2:2 + count])
            r += count
            live = True

            if controller.should_stop(p):
                save(blocking=True)
                completed = False
                report.preempted = True
                if log_fn is not None:
                    log_fn(f"elastic: preempted at block {r}; "
                           + ("checkpointed, " if ckpt is not None else "")
                           + "exiting cleanly")
                break
            if ckpt is not None and ckpt_every and r % ckpt_every == 0:
                save()
    finally:
        controller.guard = guard
        if ckpt is not None:
            ckpt.wait()
    if ckpt is not None:
        # no rank reads the directory before rank 0 has written it
        sdist.agreed(False, pool, dev)
    if p < pool_n:
        # the ranks outside the last width return the run's state too
        reshard.broadcast_state(params, opt_state, pool)
    return ElasticStreamState(params=params, opt_state=opt_state,
                              losses=losses, report=report, cursor=r,
                              completed=completed, carries=local)

