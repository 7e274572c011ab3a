"""Fanout-sampled round streaming against the host store (port of
``repro.hoststore.sampled``).

One round = one checkpoint block of ``win`` snapshots, exactly like the
full-graph distributed stream — but instead of reconstructing full
snapshots on device, each round:

1. draws a seed batch (one batch per ROUND, shared by all ``win`` steps:
   the temporal stage threads state across the round's time axis, so
   every step must speak the same local node vocabulary);
2. runs ``graph/sampler.py`` fanout expansion per step against the
   store's CSR in host worker processes, takes the DEDUPLICATED UNION of
   the hop blocks as that step's message subgraph (full fanout makes
   the union the full edge set — the equivalence regime);
3. merges the per-step samples into one round node table (seeds first,
   then the remaining sampled vertices in ascending global id),
   re-indexes every step's edges into table-local ids, and gathers
   features / labels / edge values for sampled lanes only;
4. emits fixed-size padded tensors sized by ``ResolvedSampling`` —
   blowing a static budget degrades to dropped lanes counted on
   ``SampleReport``, never a shape change.

:func:`draw_seeds`, :func:`sample_round` and its per-step expansion are
host numpy copied from the reference, so a round is byte-identical to
the reference's for the same (seed, epoch, round).  Under the port's one
process per rank every rank samples the whole round (its table needs
every step's sample; the sampling is deterministic, so the ranks agree)
and ``SampledSliceStream.stage_fn`` ships only the rank's own time slice
— steps ``r bsl ... (r + 1) bsl - 1`` of the round — onto its device,
through the prefetch machinery's ``SideStream`` (a side CUDA stream and
an event a round) in place of the reference's ``NamedSharding``
placement.  The staged payload per round is O(table_pad + edge_pad),
independent of N.

The reference expands a round's steps in ``spec.workers`` threads; the
sampler's per-vertex Python loop holds the interpreter lock, so they
run one at a time.  The port sends each step — its CSR, edge values and the seeds — to one of
``spec.workers`` processes of its stream's pool (spawned, never
forked: the parent holds a CUDA context and other threads).  Every step
draws from its own (seed, epoch, step) generator, so which worker runs
it changes nothing: the round stays byte-identical.

Thread discipline: per-round counters and timings ride ON the round
item through the prefetch queue (the queue's lock is the happens-before
edge); the consumer folds them into the shared ``SampleReport`` on the
main thread — no cross-thread attribute writes at all.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import Executor, ProcessPoolExecutor
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch import obs
from repro_torch.graph import sampler as smp
from repro_torch.hoststore.spec import ResolvedSampling, SamplingSpec
from repro_torch.hoststore.store import TemporalCSRStore
from repro_torch.stream.prefetch import SideStream, Staged


@dataclass
class SampleReport:
    """Health/accounting counters of one sampled run (main-thread owned).
    ``staged_bytes`` counts what this rank shipped host->device: its
    slice of each round and its lanes of the carries."""

    rounds: int = 0
    sampled_edges: int = 0        # valid union edges staged
    sampled_nodes: int = 0        # valid table lanes staged
    dropped_nodes: int = 0        # table-budget overflow (degraded lanes)
    dropped_edges: int = 0        # edge-budget overflow (degraded lanes)
    staged_bytes: int = 0         # bytes shipped host->device
    sample_seconds: float = 0.0   # host sampling+merge time
    stage_seconds: float = 0.0    # staging (enqueue) time
    step_seconds: float = 0.0     # forced device step time (trainer-owned)
    table_fill_max: int = 0       # worst observed table occupancy

    def fold(self, rnd: "StagedRound") -> None:
        self.rounds += 1
        self.sampled_edges += rnd.sampled_edges
        self.sampled_nodes += len(rnd.node_ids)
        self.dropped_nodes += rnd.dropped_nodes
        self.dropped_edges += rnd.dropped_edges
        self.staged_bytes += rnd.staged_bytes
        self.sample_seconds += rnd.sample_s
        self.stage_seconds += rnd.stage_s
        self.table_fill_max = max(self.table_fill_max, len(rnd.node_ids))
        # mirror into the shared namespace; fold() runs on the main
        # thread, so the registry sees the same happens-before edge the
        # report does
        obs.inc("sample.rounds")
        obs.inc("sample.dropped_nodes", rnd.dropped_nodes)
        obs.inc("sample.dropped_edges", rnd.dropped_edges)
        obs.inc("sample.staged_bytes", rnd.staged_bytes)


@dataclass
class SampleRound:
    """Host-side product of one round's sampling (numpy, pre-staging)."""

    r: int                      # round index within the epoch
    t0: int                     # global step index of the round's start
    node_ids: np.ndarray        # (k,) int64 global table, seeds first
    frames: np.ndarray          # (win, table_pad, F) f32
    labels: np.ndarray          # (win, table_pad) i32
    edges: np.ndarray           # (win, edge_pad, 2) i32 table-local
    mask: np.ndarray            # (win, edge_pad) f32
    values: np.ndarray          # (win, edge_pad) f32
    sample_s: float = 0.0
    sampled_edges: int = 0
    dropped_nodes: int = 0
    dropped_edges: int = 0


@dataclass
class StagedRound:
    """Device-side round: this rank's (bsl, ...) slice of it, staged on a
    side stream (``ready``: the event after its copies, None on the CPU;
    :meth:`SampledSliceStream.receive` makes it safe to read)."""

    r: int
    t0: int
    node_ids: np.ndarray        # stays host-side (gather/scatter index)
    frames: torch.Tensor        # (bsl, table_pad, F)
    labels: torch.Tensor        # (bsl, table_pad)
    edges: torch.Tensor         # (bsl, edge_pad, 2)
    mask: torch.Tensor          # (bsl, edge_pad)
    values: torch.Tensor        # (bsl, edge_pad)
    ready: Any = None
    sample_s: float = 0.0
    stage_s: float = 0.0
    staged_bytes: int = 0
    sampled_edges: int = 0
    dropped_nodes: int = 0
    dropped_edges: int = 0


def _step_rng(seed: int, epoch: int, t: int) -> np.random.Generator:
    """Per-(stream-seed, epoch, step) generator: sampling is deterministic
    under any worker-thread schedule because no generator is shared."""
    return np.random.default_rng(np.random.SeedSequence([seed, epoch, t]))


def draw_seeds(num_nodes: int, num_seeds: int, seed: int, epoch: int,
               r: int) -> np.ndarray:
    """The round's seed batch.  ``num_seeds >= num_nodes`` pins the
    identity batch (every vertex, ascending) — the equivalence regime."""
    if num_seeds >= num_nodes:
        return np.arange(num_nodes, dtype=np.int64)
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, epoch, 2_000_003 + r]))
    return np.sort(rng.choice(num_nodes, size=num_seeds,
                              replace=False).astype(np.int64))


@dataclass
class _Step:
    """What one step's expansion reads of the store: its CSR, its edge
    values and N (small enough to send to a worker process)."""

    graph: smp.CSRGraph
    values: np.ndarray
    num_nodes: int

    def csr(self, t: int) -> smp.CSRGraph:
        return self.graph

    def values_csr(self, t: int) -> np.ndarray:
        return self.values


def _sample_step_task(args: tuple):
    """:func:`_sample_step` on a ``(_Step, t, seeds, spec, epoch)`` task."""
    return _sample_step(*args)


def _sample_step(store: TemporalCSRStore, t: int, seeds: np.ndarray,
                 spec: SamplingSpec, epoch: int):
    """One step's fanout expansion -> (global nodes, unique global edges,
    values) with sampler-output invariants trimmed to valid lanes."""
    sub = smp.sample_neighbors(store.csr(t), seeds, list(spec.fanouts),
                               _step_rng(spec.seed, epoch, t))
    n_valid = int(sub.node_mask.sum())
    nodes = sub.node_ids[:n_valid]
    gsrc, gdst, pos = [], [], []
    for blk in sub.blocks:
        e = int(blk.edge_mask.sum())
        if not e:
            continue
        gsrc.append(nodes[blk.edges[:e, 0]])
        gdst.append(nodes[blk.edges[:e, 1]])
        pos.append(blk.edge_pos[:e])
    if not gsrc:
        return (nodes, np.zeros((0, 2), dtype=np.int64),
                np.zeros((0,), dtype=np.float32))
    gsrc = np.concatenate(gsrc)
    gdst = np.concatenate(gdst)
    pos = np.concatenate(pos)
    # dedup the hop-block union: an edge sampled at two hops must carry
    # one message, not two (full fanout: union == the full edge set)
    keys = gsrc * np.int64(store.num_nodes) + gdst
    _, first = np.unique(keys, return_index=True)
    edges = np.stack([gsrc[first], gdst[first]], axis=1)
    vals = store.values_csr(t)[pos[first]].astype(np.float32)
    return nodes, edges, vals


def sample_round(store: TemporalCSRStore, frames: np.ndarray,
                 labels: np.ndarray, spec: SamplingSpec,
                 resolved: ResolvedSampling, win: int, r: int, epoch: int,
                 pool: Executor) -> SampleRound:
    """Sample one round: per-step expansions in worker threads, merged
    into one table + fixed-size padded tensors.  Runs on the prefetch
    thread; its span/timing rides back on ``SampleRound.sample_s``."""
    with obs.stopwatch("sample.round", cat="sample", round=r,
                       epoch=epoch) as sw:
        rnd = _sample_round_body(store, frames, labels, spec, resolved,
                                 win, r, epoch, pool)
    rnd.sample_s = sw.seconds
    return rnd


def _sample_round_body(store: TemporalCSRStore, frames: np.ndarray,
                       labels: np.ndarray, spec: SamplingSpec,
                       resolved: ResolvedSampling, win: int, r: int,
                       epoch: int, pool: Executor) -> SampleRound:
    t0 = r * win
    n = store.num_nodes
    seeds = draw_seeds(n, resolved.num_seeds, spec.seed, epoch, r)
    per_step = list(pool.map(_sample_step_task, [
        (_Step(store.csr(t), store.values_csr(t), n), t, seeds, spec, epoch)
        for t in range(t0, t0 + win)]))

    # round table: seeds first (loss lanes), then every other sampled
    # vertex ascending — deterministic under any thread schedule
    extra = np.setdiff1d(
        np.unique(np.concatenate([nodes for nodes, _, _ in per_step])),
        seeds, assume_unique=False)
    table = np.concatenate([seeds, extra])
    dropped_nodes = max(0, table.shape[0] - resolved.table_pad)
    table = table[:resolved.table_pad]
    k = table.shape[0]

    # global id -> table-local rank (searchsorted over the sorted view)
    sort_idx = np.argsort(table, kind="stable")
    sorted_ids = table[sort_idx]

    def to_local(ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        p = np.clip(np.searchsorted(sorted_ids, ids), 0, k - 1)
        ok = sorted_ids[p] == ids
        return sort_idx[p].astype(np.int32), ok

    e_pad = resolved.edge_pad
    edges = np.zeros((win, e_pad, 2), dtype=np.int32)
    mask = np.zeros((win, e_pad), dtype=np.float32)
    values = np.zeros((win, e_pad), dtype=np.float32)
    sampled_edges = dropped_edges = 0
    for i, (_, ge, gv) in enumerate(per_step):
        if not ge.shape[0]:
            continue
        lsrc, ok_s = to_local(ge[:, 0])
        ldst, ok_d = to_local(ge[:, 1])
        keep = ok_s & ok_d              # endpoints dropped by table overflow
        lsrc, ldst, gv = lsrc[keep], ldst[keep], gv[keep]
        e = lsrc.shape[0]
        dropped_edges += max(0, e - e_pad)
        e = min(e, e_pad)
        edges[i, :e, 0] = lsrc[:e]
        edges[i, :e, 1] = ldst[:e]
        mask[i, :e] = 1.0
        values[i, :e] = gv[:e]
        sampled_edges += e

    f_sub = np.zeros((win, resolved.table_pad, frames.shape[-1]),
                     dtype=np.float32)
    l_sub = np.zeros((win, resolved.table_pad), dtype=np.int32)
    f_sub[:, :k] = frames[t0:t0 + win][:, table]
    l_sub[:, :k] = labels[t0:t0 + win][:, table]

    return SampleRound(r=r, t0=t0, node_ids=table, frames=f_sub,
                       labels=l_sub, edges=edges, mask=mask, values=values,
                       sampled_edges=sampled_edges,
                       dropped_nodes=dropped_nodes,
                       dropped_edges=dropped_edges)


@dataclass
class SampledSliceStream:
    """The sampled round pipeline stage: host sampling -> this rank's
    time slice of each round, staged on its device.

    Drives the same producer/consumer protocol as the full-graph round
    stream: ``rounds(epoch)`` is the host iterator the prefetch thread
    drains, ``stage_fn()`` the staging callable it applies, and
    :meth:`receive` (consumer thread) makes a staged round ready on the
    consumer's current stream."""

    store: TemporalCSRStore
    frames: np.ndarray
    labels: np.ndarray
    spec: SamplingSpec
    resolved: ResolvedSampling
    win: int
    rank: int = 0
    num_shards: int = 1
    device: Any = "cuda"
    _side: SideStream = field(init=False)
    _pool: ProcessPoolExecutor = field(init=False)

    def __post_init__(self):
        if self.win % self.num_shards:
            raise ValueError(f"block_size {self.win} must divide into "
                             f"{self.num_shards} shards")
        self._side = SideStream(self.device)
        # its processes start at the first round and serve every epoch:
        # each start costs seconds (a worker imports the package)
        self._pool = ProcessPoolExecutor(
            max_workers=self.spec.workers,
            mp_context=multiprocessing.get_context("spawn"))

    def close(self) -> None:
        """Stop the sampling processes (the stream samples no more)."""
        self._pool.shutdown()

    @property
    def rounds_per_epoch(self) -> int:
        return self.store.num_steps // self.win

    @property
    def bsl(self) -> int:
        """Steps of a round this rank trains (win / P)."""
        return self.win // self.num_shards

    def rounds(self, epoch: int):
        """Host iterator of one epoch's ``SampleRound``s (runs on the
        prefetch thread; each round's steps are expanded in the stream's
        ``spec.workers`` processes)."""
        for r in range(self.rounds_per_epoch):
            yield sample_round(self.store, self.frames, self.labels,
                               self.spec, self.resolved, self.win, r, epoch,
                               self._pool)

    def stage_fn(self):
        """Round staging for the prefetch thread: this rank's slice of
        every tensor ships on the side stream; timings and bytes ride on
        the item."""
        sl = slice(self.rank * self.bsl, (self.rank + 1) * self.bsl)

        def stage(rnd: SampleRound) -> StagedRound:
            with obs.stopwatch("sample.stage", cat="sample",
                               round=rnd.r) as sw:
                host = (rnd.frames[sl], rnd.labels[sl], rnd.edges[sl],
                        rnd.mask[sl], rnd.values[sl])
                staged = self._side.stage(host)
                staged_round = StagedRound(
                    r=rnd.r, t0=rnd.t0, node_ids=rnd.node_ids,
                    frames=staged.item[0], labels=staged.item[1],
                    edges=staged.item[2], mask=staged.item[3],
                    values=staged.item[4], ready=staged.ready,
                    sample_s=rnd.sample_s, sampled_edges=rnd.sampled_edges,
                    dropped_nodes=rnd.dropped_nodes,
                    dropped_edges=rnd.dropped_edges,
                    staged_bytes=sum(a.nbytes for a in host))
            staged_round.stage_s = sw.seconds
            return staged_round

        return stage

    def receive(self, rnd: StagedRound) -> StagedRound:
        """Make ``rnd``'s tensors ready on the consumer's current stream
        (a wait on its event; nothing on the CPU)."""
        self._side.receive(Staged((rnd.frames, rnd.labels, rnd.edges,
                                   rnd.mask, rnd.values), rnd.ready))
        return rnd
