"""Distributed streamed training: per-rank delta streams under the
fixed-volume snapshot distribution (paper §3.2 x §4.2, composed).

Port of ``repro.stream.distributed``, one process per rank on a
``torch.distributed`` process group (gloo on the CPU, NCCL with rank r on
``cuda:r``), where the reference drives every shard from one process:

* rank r encodes only ITS time-slice stream
  (``sharded.encode_time_sliced(..., shards=[r])``, the reference's
  ``encode_time_sliced(...)[r]``), once, and replays it every epoch;
* it stages its own items — on its prefetch thread, on a side CUDA stream
  (``prefetch.SideStream``) — and its own ``(bsl, N, F)`` frames and
  ``(bsl, N)`` labels, steps ``t0 + r bsl ...`` of each round; there is
  no global array to assemble;
* it applies its deltas in its own ``DeltaApplier`` ring and stacks the
  round's ``bsl`` snapshots (``SlotStacker``);
* one round = one checkpoint block of ``win`` snapshots: the step builds
  the CSR pairs of the rank's snapshots, runs the snapshot-parallel block
  body (``core.partition.snapshot_block_body``: the GCN stage local, the
  temporal stage reached through two fixed-volume all-to-alls per layer)
  WITHOUT a checkpoint around it, differentiates the rank's share of the
  mean CE (``local_nll_sum / (bsl P N)``), all-reduces each gradient leaf
  and updates the replicated parameters with AdamW alike on every rank.

The temporal carries are vertex-sharded (N/P rows), live on the rank
between rounds, are detached at every round boundary (the reference's
carries enter ``value_and_grad`` as inputs) and restart from zeros every
epoch, as do the int8 error-feedback residuals.  Loss semantics match
``train_loop.train_streamed(slice_len=win)`` (same slice, same mean CE,
same AdamW cadence), pinned at rtol 1e-5 by
``tests/test_torch_dist_stream.py``.

Two schedule knobs pipeline the round (losses unchanged):

* ``a2a_chunks=C`` chunks each of the two per-layer redistributions into
  C feature-sliced all-to-alls;
* ``pipeline_rounds=True`` alternates two ``DeltaApplier`` /
  ``SlotStacker`` rings and keeps ONE round in flight: round r's loss is
  read to the host only after round r+1's apply and step are queued.

Every rank issues the same collectives in the same order (the two
all-to-alls a layer, the scale all-to-alls under compression, one
all-reduce a gradient leaf, the loss's all-reduce); no rank-dependent
branch skips one, and a group orders its collectives, so queuing ahead is
safe.  ``compression`` ("int8_a2a", "int8_all") quantizes the
all-to-alls with error feedback (``dist.compression``); "int8_all" also
encodes the delta stream on the narrow ``stream.wire`` format.

The elastic entry (``start_round``, ``carries``, ``stop_fn``) runs one
epoch's rounds from a checkpoint-block boundary, and stops at a round
boundary when ``stop_fn`` says so; ``repro_torch.elastic`` drives its
segments through it.  A SIGTERM may reach one rank and not the others,
so the ranks AGREE on stopping: each round's ``stop_fn`` answers are
reduced with ``all_reduce(MAX)`` over the group before any rank acts on
them, and every rank leaves the loop after the same round.  Every round
feeds its wall time to a ``StepTimer`` (``step_timer``; the straggler
watchdog's ``straggler.flags`` counter).

A traced run (an enabled, fencing tracer with ``phases`` on) also
records the reference's derived ``round.spatial`` / ``round.a2a`` /
``round.temporal`` spans inside each fenced ``round.step``.  The step has
no per-phase fence, so after round 0's step of each call rank 0 times the
same step over a one-rank group on the round's whole data (its
communication-free compute reference, ``round.probe``), and every rank
splits its steps by it (``_dist_phase_probe``, ``_emit_phase_spans``;
``obs.calibrate`` joins them against ``dist.overlap.round_time_model``).
The probe runs on copies: a traced run's losses and parameters equal an
untraced run's bit for bit.  Its three steps on rank 0 add to the
kernels' launch counts, the CSR-build count and ``partition.a2a_*`` what
three steps of a one-rank round of ``win`` snapshots add, and three
``stream.csr_pair`` spans to the trace, and nothing else.

Not ported here: the reference's ``lowered_step_hlo`` (XLA HLO; the
``partition.a2a_*`` byte counters take its place).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs, resolve_device
from repro_torch.core import models as mdl
from repro_torch.core import partition
from repro_torch.dist import compression as compression_lib
from repro_torch.dist.sharding import all_gather, group_rank, group_size
from repro_torch.ft.straggler import StepTimer
from repro_torch.optim import adamw
from repro_torch.stream import encoder as enc
from repro_torch.stream import sharded as stream_sharded
from repro_torch.stream import train_loop as tl
from repro_torch.stream.prefetch import (DeltaApplier, PrefetchIterator,
                                         SlotStacker, stage_item)

def _detached(tree, clone: bool = False):
    """A carry tree (nested tuples and lists of tensors), detached from
    the graph (and copied when ``clone``)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_detached(t, clone) for t in tree)
    return tree.detach().clone() if clone else tree.detach()


@dataclass
class DistStreamState:
    params: mdl.ParamTree
    opt_state: dict
    losses: list
    per_shard_bytes: list = field(default_factory=list)
    carries: object = None          # the rank's final temporal carries
    step_timer: object = None       # the run's StepTimer (EWMA watchdog)


def make_dist_stream_step(cfg: mdl.DynGNNConfig, group,
                          opt_cfg: adamw.AdamWConfig, a2a_chunks: int = 1,
                          compression: str = "none",
                          num_seeds: int | None = None):
    """The per-round step on this rank: its reconstructed snapshots ->
    self-loops and Laplacian weights -> the CSR pair of each snapshot ->
    the snapshot-parallel block body (2 all-to-alls a layer) -> its share
    of the mean CE -> gradients, one all-reduce a leaf -> AdamW (in
    place).

    ``step(params, opt_state, carries, comm_res, frames (bsl, N, F),
    edges (bsl, E, 2), mask, values (bsl, E), labels (bsl, N), t0) ->
    (params, opt_state, carries, comm_res, loss)``.  ``comm_res`` is the
    rank's error-feedback residuals (``init_comm_residuals``) when
    ``compression`` != "none", returned updated, and None otherwise.
    ``loss`` is the all-reduced mean on the device.  The carries and
    residuals come back detached.

    ``num_seeds`` is the sampled schedule's loss restriction
    (``repro_torch.hoststore``): the vertex axis is then a round-local
    node TABLE whose first ``num_seeds`` lanes are the seed batch, and
    only those lanes carry loss (the mean over the round's steps and
    seeds).  ``None`` (the full-graph schedules) keeps the all-vertices
    mean.
    """
    if a2a_chunks < 1:
        raise ValueError(f"a2a_chunks must be >= 1, got {a2a_chunks}")
    compression_lib.validate_mode(compression)
    num_procs = group_size(group)
    n = cfg.num_nodes
    if n % num_procs:
        raise ValueError(f"num_nodes {n} must divide over {num_procs} "
                         f"snapshot shards (vertex-sharded temporal stage)")
    if num_seeds is not None and not 1 <= num_seeds <= n:
        raise ValueError(f"num_seeds {num_seeds} must lie in [1, {n}]")
    loss_lanes = n if num_seeds is None else num_seeds
    loops: dict = {}                 # device -> (self-loop edges, ones)

    def step(params, opt_state, carries, comm_res, frames, edges, mask,
             values, labels, t0):
        bsl = frames.shape[0]
        dev = frames.device
        if dev not in loops:
            loops[dev] = tl.make_self_loops(n, dev)
        e_full, w_full = tl.slice_weights_with_loops(n, *loops[dev], edges,
                                                     mask, values)
        with obs.span("stream.csr_pair", snapshots=bsl) as sp:
            csrs = partition.local_csrs(e_full[None], w_full[None], n)
            sp.fence(csrs[-1][1][0])
        new_carries, h, new_res = partition.snapshot_block_body(
            cfg, params, group, carries, (frames, e_full, w_full, t0), csrs,
            a2a_chunks=a2a_chunks, compression=compression,
            comm_residuals=comm_res)
        nll = tl.slice_nll(params, h, labels)
        if num_seeds is not None:
            nll = nll[:, :num_seeds]
        share = nll.sum() / (bsl * num_procs * loss_lanes)
        leaves = list(params.parameters())
        grads = torch.autograd.grad(share, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads, strict=True)]
        for g in grads:
            dist.all_reduce(g, group=group)
        loss = share.detach().clone()
        dist.all_reduce(loss, group=group)
        params, opt_state = adamw.apply_updates(opt_cfg, params, grads,
                                                opt_state)
        return params, opt_state, _detached(new_carries), new_res, loss

    return step


def init_sharded_carries(cfg: mdl.DynGNNConfig, params, group) -> list:
    """Zero carries of this rank's N/P vertex rows (EvolveGCN's weight
    carry whole), detached copies on the parameters' device."""
    device = params["classifier"]["u"].device
    carries = mdl.init_carries(cfg, params, device=device,
                               num_local_nodes=cfg.num_nodes
                               // group_size(group))
    return _detached(carries, clone=True)


def init_comm_residuals(cfg: mdl.DynGNNConfig, win: int, group,
                        device=None) -> list:
    """Zero error-feedback residuals of this rank's quantized
    redistributions: one ``(res_t2n (win/P, N, f_t2n), res_n2t (win,
    N/P, f_n2t))`` pair per layer in the PRE-all-to-all layouts (its
    slices of the reference's sharded residuals; empty for EvolveGCN)."""
    p, n = group_size(group), cfg.num_nodes
    return [(torch.zeros((win // p, n, f1), device=device),
             torch.zeros((win, n // p, f2), device=device))
            for f1, f2 in partition.a2a_payload_dims(cfg)]


def dist_round_stream(shard_stream, frames, labels, win: int, bsl: int,
                      rank: int, start_round: int = 0):
    """Host iterator of this rank's rounds: (its ``bsl`` delta items,
    frames (bsl, N, F), labels (bsl, N)) of steps ``t0 + rank bsl ...``
    with ``t0 = r win``.  ``start_round`` resumes mid-epoch: the given
    ``shard_stream`` begins at that round's block."""
    rounds = len(shard_stream) // bsl
    for r in range(rounds):
        items = tuple(shard_stream[r * bsl + j] for j in range(bsl))
        t0 = (start_round + r) * win + rank * bsl
        yield (items, np.asarray(frames[t0:t0 + bsl]),
               np.asarray(labels[t0:t0 + bsl]))


def consume_round(items, applier: DeltaApplier, stacker: SlotStacker):
    """Drive one round's staged delta items through this rank's ring:
    ``applier`` applies them, ``stacker`` copies each reconstructed slot
    out of the ring -> the rank's ``(edges, mask, values)`` block, queued
    only (nothing waits for the device)."""
    for j, item in enumerate(items):
        stacker.put(j, *applier.consume(item))
    return stacker.arrays()


def _gather_bytes(mine: int, group, device) -> list[int]:
    """Every rank's stream payload, by rank (one all-reduce)."""
    buf = torch.zeros(group_size(group), dtype=torch.int64, device=device)
    buf[group_rank(group)] = mine
    dist.all_reduce(buf, group=group)
    return [int(b) for b in buf.tolist()]


def agreed(flag: bool, group, device) -> bool:
    """True on every rank of ``group`` when ``flag`` is True on any (one
    ``all_reduce(MAX)``): the decision the ranks act on together."""
    buf = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
    return bool(buf.item())


def _probe_group(mesh):
    """The probe's one-rank group: ``mesh`` itself at P = 1, else a new
    group of ``mesh``'s rank 0 alone (None on the other ranks).  Every rank
    of ``mesh`` calls this, in one order, before the round loop; local
    synchronization spares the ranks outside ``mesh`` (an elastic pool's
    idle ranks) from joining the creation."""
    if group_size(mesh) == 1:
        return mesh
    return dist.new_group([dist.get_global_rank(mesh, 0)],
                          use_local_synchronization=True)


def _dist_phase_probe(cfg, opt_cfg, params, opt_state, blk, frames,
                      labels, t0: int, mesh, group1, dev
                      ) -> tuple[float, float]:
    """One-time comp-reference measurement for derived phase spans.

    The round step has no fence between its phases, so the spatial / a2a
    / temporal phases cannot be timed inside it.  As the reference does,
    rank 0 runs the SAME step over a one-rank group (``group1``, where the
    two all-to-alls are local copies) on this round's whole data, gathered
    from every rank: that is the round's communication-free compute
    reference (best of 2 timed runs after a warm one, each a
    ``round.probe`` stopwatch).  Per round, ``a2a = step - comp_ref`` and
    the remaining compute splits between the spatial and temporal stages
    by their analytic flop ratio.  The step updates its parameters in
    place, so every run gets its own copy of the parameters and AdamW
    state, and fresh zero carries; the caller's are never touched.  Every
    rank calls this (the gathers and the broadcast are collectives) ->
    ``(comp_ref_s, f_spatial)`` on every rank."""
    whole = [all_gather(x, mesh).flatten(0, 1)
             for x in (*blk, frames, labels)]
    out = torch.zeros(2, dtype=torch.float64, device=dev)
    if group1 is not None:
        edges, mask, values, fr, lab = whole
        step1 = make_dist_stream_step(cfg, group1, opt_cfg)
        opt1 = copy.deepcopy(opt_state)
        carries1 = init_sharded_carries(cfg, params, group1)
        trc = obs.get_tracer()

        def run(params1):
            loss = step1(params1, opt1, carries1, None, fr, edges, mask,
                         values, lab, t0)[-1]
            loss.item()                       # wait for the device

        copies = [copy.deepcopy(params) for _ in range(3)]
        run(copies.pop())                     # warm
        best = None
        while copies:
            params1 = copies.pop()
            with trc.stopwatch("round.probe", cat="probe") as sw:
                run(params1)
            best = sw.seconds if best is None else min(best, sw.seconds)
        e_mean = float(mask.sum(dtype=torch.float64)) / mask.shape[0]
        feat = cfg.hidden
        fl_spatial = 2 * e_mean * 2 * feat + 2 * cfg.num_nodes * feat * feat
        fl_temporal = 2 * cfg.window * cfg.num_nodes * feat * feat
        out[0], out[1] = best, fl_spatial / (fl_spatial + fl_temporal)
    dist.broadcast(out, src=dist.get_global_rank(mesh, 0), group=mesh)
    comp_ref, f_sp = out.tolist()
    return comp_ref, f_sp


def _emit_phase_spans(trc, ridx: int, step_span, comp_ref: float,
                      f_sp: float) -> None:
    """Derived spatial/a2a/temporal child spans inside one measured
    ``round.step`` span (marked ``derived``); they sum to its duration."""
    step_s = step_span.dur_s
    a2a_s = max(step_s - comp_ref, 0.0)
    comp_s = step_s - a2a_s
    sp_s = f_sp * comp_s
    t0 = step_span.start_s
    trc.add_span("round.spatial", t0, sp_s, cat="phase.derived",
                 round=ridx, derived=True)
    trc.add_span("round.a2a", t0 + sp_s, a2a_s, cat="phase.derived",
                 round=ridx, derived=True)
    trc.add_span("round.temporal", t0 + sp_s + a2a_s, comp_s - sp_s,
                 cat="phase.derived", round=ridx, derived=True)


def train_distributed_streamed(cfg: mdl.DynGNNConfig, snapshots, values,
                               frames, labels, *, mesh,
                               block_size: int | None = None,
                               num_epochs: int = 1, overlap: bool = True,
                               prefetch_depth: int = 2,
                               a2a_chunks: int = 1,
                               pipeline_rounds: bool = False,
                               compression: str = "none",
                               opt_cfg: adamw.AdamWConfig | None = None,
                               params: mdl.ParamTree | None = None,
                               opt_state=None,
                               stats: enc.DeltaStats | None = None,
                               max_edges: int | None = None,
                               step_fn=None, shard_stream=None,
                               start_round: int = 0, carries=None,
                               stop_fn=None, seed: int = 0,
                               log_every: int = 10, log_fn=None,
                               step_timer: StepTimer | None = None,
                               device: str | torch.device = "cuda"
                               ) -> DistStreamState:
    """Stream the trace through snapshot-parallel distributed training, as
    this rank of the process group ``mesh``.

    One round per checkpoint block (``win = block_size`` snapshots): the
    rank receives only its ``win/P`` owned deltas (1/P of the transfer
    volume), reconstructs them on ``device``, and the round's one step
    crosses ranks only through the two all-to-alls a layer and the
    gradient all-reduces.  ``overlap=True`` stages round r+1 on the
    prefetch thread while round r trains; both schedules give identical
    losses, as do ``a2a_chunks`` and ``pipeline_rounds`` (see the module
    docstring).  ``compression`` != "none" changes the numerics within the
    drift bound of the tests; "none" is bit-identical to leaving it out.

    ``params`` (a ``ParamTree``, moved to ``device`` and updated in place)
    default to ``mdl.init_params`` from ``seed``; ``step_fn`` /
    ``shard_stream`` (this rank's encoded stream) let repeated calls reuse
    one step and one encode, and must match (cfg, group, block,
    a2a_chunks, compression).  Every round runs in a ``round`` stopwatch
    with fenced ``round.transfer`` / ``round.step`` spans when tracing is
    on (fencing serializes the schedule), and adds to ``stream.rounds``;
    the call adds the rank's payload bytes to ``stream.payload_bytes``.

    ``start_round`` / ``carries`` / ``stop_fn`` are the resumable-from-
    block entry the elastic loop (``repro_torch.elastic``) drives its
    segments through: run the rounds of ONE epoch from checkpoint-block
    boundary ``start_round`` (``shard_stream``, when given, begins there)
    with this rank's initial ``carries`` (None = fresh zeros), and stop
    at the next round boundary when ``stop_fn(global_round)`` is True on
    any rank (agreed by ``all_reduce(MAX)``; with ``pipeline_rounds`` the
    in-flight round is drained first).  The final carries ride back on
    ``DistStreamState.carries``.  ``step_timer`` (a ``StepTimer``, shared
    across segments) observes each round's wall time.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        # the prefetch thread stages onto this rank's card, not the
        # thread's default one
        dev = torch.device("cuda", torch.cuda.current_device())
    t_steps = len(snapshots)
    num_procs, rank = group_size(mesh), group_rank(mesh)
    win = block_size or max(t_steps // max(cfg.checkpoint_blocks, 1), 1)
    if win % num_procs:
        raise ValueError(f"block_size {win} must divide into {num_procs} "
                         "shards")
    if t_steps % win:
        raise ValueError(f"trace length {t_steps} must be a multiple of "
                         f"block_size {win}")
    if (start_round or carries is not None) and num_epochs != 1:
        raise ValueError(
            "start_round/carries resume one epoch segment; run with "
            "num_epochs=1 and loop epochs in the caller "
            "(repro_torch.elastic)")
    bsl = win // num_procs
    max_edges = max_edges or tl.default_max_edges(snapshots)
    if stats is None and shard_stream is None:
        stats = enc.measure_stats(snapshots, cfg.num_nodes, win, max_edges)
    opt_cfg = opt_cfg or adamw.AdamWConfig(
        lr=1e-2, warmup_steps=10, total_steps=num_epochs * t_steps,
        weight_decay=0.0)
    if params is None:
        params = mdl.init_params(torch.Generator().manual_seed(seed), cfg)
    params = params.to(dev)
    if opt_state is None:
        opt_state = adamw.init_state(params)
    if step_fn is None:
        step_fn = make_dist_stream_step(cfg, mesh, opt_cfg,
                                        a2a_chunks=a2a_chunks,
                                        compression=compression)
    # this rank's self-contained time-slice stream, encoded once and
    # replayed every epoch: each round opens with a FullSnapshot
    if shard_stream is None:
        shard_stream = stream_sharded.encode_time_sliced(
            snapshots, values, cfg.num_nodes, max_edges, win, num_procs,
            stats, start_step=start_round * win,
            wire=compression_lib.wire_mode(compression), shards=[rank])[0]
    mine = sum(item.payload_bytes for item in shard_stream)
    per_shard_bytes = _gather_bytes(mine, mesh, dev)
    # pipeline_rounds alternates two rings: round r uses buffer r % 2
    nbuf = 2 if pipeline_rounds else 1

    losses: list[float] = []

    def emit(loss: torch.Tensor) -> None:
        losses.append(loss.item())
        if log_fn is not None and (len(losses) - 1) % log_every == 0:
            log_fn(f"dist stream round {len(losses) - 1} "
                   f"loss {losses[-1]:.4f} "
                   f"(P={num_procs}, win={win}, C={a2a_chunks}, "
                   f"pipelined={pipeline_rounds})")

    timer = step_timer if step_timer is not None else StepTimer()
    initial_carries = carries
    stopped = False
    obs.inc("stream.payload_bytes", mine)
    trc = obs.get_tracer()
    # derived phase spans need fenced (execution-timed) measurements and
    # the probe, whose gathers and broadcast every rank must join: the
    # ranks agree on it once
    derive_phases = agreed(trc.enabled and trc.phases and trc.fencing,
                           mesh, dev)
    group1 = _probe_group(mesh) if derive_phases else None
    probe: tuple[float, float] | None = None      # (comp_ref_s, f_spatial)
    ridx = start_round       # span round index, monotonic across epochs
    for _ in range(num_epochs):
        host = dist_round_stream(shard_stream, frames, labels, win, bsl,
                                 rank, start_round)
        rounds = (PrefetchIterator(host, depth=prefetch_depth, device=dev)
                  if overlap else (stage_item(x, dev) for x in host))
        appliers = [DeltaApplier(max_edges, dev) for _ in range(nbuf)]
        stackers = [SlotStacker(bsl) for _ in range(nbuf)]
        carries = (initial_carries if initial_carries is not None
                   else init_sharded_carries(cfg, params, mesh))
        initial_carries = None           # later epochs start fresh
        # the residuals restart with the carries: they are the quantizer's
        # state, not the model's
        comm_res = (init_comm_residuals(cfg, win, mesh, dev)
                    if compression_lib.compresses_a2a(compression)
                    else None)
        in_flight = None        # round r-1's device loss (pipeline_rounds)
        try:
            for r, (items, fr, lab) in enumerate(rounds):
                buf = r % nbuf
                gr = start_round + r
                with obs.stopwatch("round", cat="round", round=ridx,
                                   p=num_procs, win=win) as round_sw:
                    with obs.span("round.transfer", round=ridx) as sp:
                        blk = sp.fence(consume_round(items, appliers[buf],
                                                     stackers[buf]))
                    with obs.span("round.step", round=ridx) as st_sp:
                        params, opt_state, carries, comm_res, loss = \
                            step_fn(params, opt_state, carries, comm_res,
                                    fr, *blk, lab, gr * win)
                        st_sp.fence(loss)
                    if pipeline_rounds:
                        # read round r-1's loss only now: round r's apply
                        # and step are already queued behind it
                        if in_flight is not None:
                            emit(in_flight)
                        in_flight = loss
                    else:
                        emit(loss)
                obs.inc("stream.rounds")
                timer.observe(round_sw.seconds)  # counts straggler.flags
                if derive_phases:
                    if probe is None:
                        probe = _dist_phase_probe(
                            cfg, opt_cfg, params, opt_state, blk, fr, lab,
                            gr * win, mesh, group1, dev)
                        if group1 is not None and group1 is not mesh:
                            dist.destroy_process_group(group1)
                    _emit_phase_spans(trc, ridx, st_sp, *probe)
                ridx += 1
                if stop_fn is not None and agreed(stop_fn(gr), mesh, dev):
                    stopped = True
                    break
            if in_flight is not None:       # the pipelined epoch's tail
                emit(in_flight)
        finally:
            if isinstance(rounds, PrefetchIterator):
                rounds.close()
        if stopped:
            break
    return DistStreamState(params=params, opt_state=opt_state,
                           losses=losses, per_shard_bytes=per_shard_bytes,
                           carries=carries, step_timer=timer)
