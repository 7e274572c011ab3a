#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU (an H100) and check it.

    python3 chip_smoke.py

Run from the root of a checkout.  It puts ``src`` on ``sys.path`` itself and
imports nothing of JAX or of the JAX package ``repro``.  Phases, each of
which exits non-zero on failure:

1. the card's name and power limit (``nvidia-smi``), then one ``nvcc`` per
   CUDA source of ``src/repro_torch/csrc``, all started together;
2. the main path: online TM-GCN serving (``paper_dyngnn``) at the full
   config's widths at the epinions scale (``DATASETS["epinions"]`` of
   ``configs/paper_dyngnn.py``: N = 755,200 nodes, 2,097,152 edge slots),
   16 windows of a 3.4 M-event synthetic CTDG stream — through
   ``repro_torch.serve.ServeEngine(device="cuda")``, whose kernel wrappers
   launch the CUDA kernels because the tensors lie on the card; every
   kernel's launch count and the CSR build count are zeroed just before
   and read just after (2 layers x 16 windows = 32 launches of each
   kernel, 16 CSR builds: one per snapshot); then node queries at batch
   1, 8, 64 and link queries on 64 pairs;
3. each kernel held to its plain PyTorch version (``ref.py``, called by
   name) on the card at the main path's shapes (the last window's graph;
   segment SpMM at the path's F = 2 and 6 and at F = 9 and 32, which run
   its generic instance (scalar and float4), then on a fully skewed
   graph, each shown to reject zeros and the kernel run with each row's
   last edge dropped),
   and timed beside its bound, its plain version and one PyTorch library
   call computing the same function (a yardstick the port never calls);
   ``banded_ttm`` at serving's call (the 4-row prefix and one new row,
   read through two pointers, one row written), shown to reject zeros, a
   dropped prefix row and a dropped slice row; the state-advance step
   timed, then profiled;
4. the same 16 windows replayed through a ``device="cpu"`` engine — where
   the wrappers run the plain versions — and its embeddings and
   last-window queries held to the card's; then small-graph serving of
   all three models, card against CPU, after every window;
4a. the training path: ``paper_dyngnn`` (TM-GCN) at the full config's
   widths trained through ``repro_torch.run.Engine(device="cuda")`` — a
   synthetic trace at N = 755,200 with T = 32 steps (cut from epinions'
   512; density 1.25, M-transform smoothed, ~2.1 M edge slots), 10 AdamW
   steps of the blocked-checkpoint trainer (nb 4), then link-prediction
   evaluation; every kernel's count is zeroed just before the fit and
   read just after (per step: 160 ``segment_spmm`` — 64 forward, 64 in
   the checkpoint recompute, 32 backward on the transposed CSR; 12
   ``banded_ttm``; 8 ``banded_ttm_t``; 0 ``flash_decode``; 64 CSR
   builds for the run), losses, fenced ``train.step`` spans, peak device
   memory beside ``activation_memory_estimate``; then the warm step
   timed, and one step profiled: device busy, its device time by kind
   (fills, copies, adds, GEMMs, each kernel) and the forward M-product's
   device time a step (its 12 launches; it needs no copy);
4b. the kernels held to their plain versions at the train path's
   shapes, each shown to reject zeros and a dropped edge / input row, and
   timed beside bound, plain version and library call: ``segment_spmm``
   on the transposed CSR at F = 6; the forward ``banded_ttm`` on
   [prefix, slice] at (T_s 8, lead 4) with t_offset -4 (block 0: its
   prefix lies before global step 1 and is never read) and +4, at (32,
   lead 0) and at the full config's block (128, lead 4), rejecting a
   dropped prefix row and a dropped slice row; ``banded_ttm_t`` on the
   kept rows' gradient dZ (T_s, N x 6) at the same four shapes (block 0:
   slice rows only); then each at small shapes over every instance its
   launcher builds: w 1-9, T_s 1-12, lead 0 and w - 1, t_offset -7..+9,
   4 and 1 columns a thread (one pointer at a time off 16-byte
   alignment), ``banded_ttm_t`` with and without the prefix's rows;
4c. one training step's loss and every gradient, card against a
   ``device="cpu"`` run from the same parameters, for all three models at
   N = 65,536, T = 16, nb 4;
4d. the streamed schedule: ``paper_dyngnn`` at the full config's widths
   over the training trace (the train phase's dataset, reused; made here
   when that phase does not run), one epoch per snapshot through
   ``Engine(mode="streamed", device="cuda")`` with the prefetch thread
   staging on a side CUDA stream, then one without it (every count
   zeroed just before each and read just after: per step 3
   ``segment_spmm`` — 2 forward, 1 backward —, 2 ``banded_ttm``, 2
   ``banded_ttm_t``, 0 ``flash_decode``, 2 CSR builds), their losses and
   parameters held bit-identical, the per-snapshot breakdown (fenced
   spans: encode, stage, apply, CSR pair, step; ``prefetch.wait``), the
   payload bytes against naive, the peak device memory and whether the
   host encoder bounds the schedule; one epoch of ``slice_len = 8`` (24
   / 2 / 2 / 0 and 16 CSR builds a step); ``banded_ttm_t`` at the step's
   (1, lead 4), slice rows only, held to its plain version, shown to
   reject zeros and a dropped row, timed beside its bound, plain version
   and cuBLAS; one snapshot's CSR-pair build timed against the F = 6
   ``segment_spmm``; then the streamed loss stream, card (prefetch
   thread) against CPU (inline), for all three models at N = 65,536,
   T = 8: every step's loss within 1e-4 relative, the first step's
   gradients within 1e-4 x each leaf's max;
4e. snapshot partitioning at P = 1 over a one-rank NCCL group (the
   machine has one card; the same code as P ranks): ``paper_dyngnn`` on
   the train phase's trace through ``Engine(plan=ExecutionPlan(mode=
   "eager", mesh=group), device="cuda")``, 10 steps from the train phase's
   seed and optimizer (every count zeroed just before and read just after:
   the train phase's 160 / 12 / 8 / 0 launches a step and 64 CSR builds,
   40 all-to-alls a step of one layer's (8, N, 6) f32 payload, none of it
   leaving the rank), the loss stream held to the train phase's at rtol
   1e-5, the warm step, one profiled step (NCCL's all-to-all ranges apart
   from the copies they span) and peak memory beside eager's, and the
   one-rank all-to-all timed on one layer's payload and on a P = 4 rank's
   beside their copy bound and ``clone()``, with its host enqueue time;
4f. ``banded_ttm`` and ``banded_ttm_t`` at a P = 4 rank's temporal shape,
   (8, lead 4) x N/4 x 6 = 1,132,800 columns, t_offset -4 and +4, held to
   their plain versions, shown to reject faults, timed beside bound, plain
   version and cuBLAS's dense band;
4g. P = 2 ranks sharing the card over gloo with CUDA tensors: two spawned
   processes (each with a join deadline) train TM-GCN at N = 65,536, T =
   8 partitioned, then on the CPU; their losses and first-step gradients
   held to each other, to the CPU's and to the card's P = 1 run over NCCL
   (1e-4 relative and 1e-4 x each leaf's max);
4h. the distributed stream at P = 1 over the one-rank NCCL group:
   ``paper_dyngnn`` on the train phase's trace (made here when that phase
   does not run), block 8 (4 rounds an epoch), 2 epochs through
   ``Engine(plan=ExecutionPlan(mode="streamed_mesh", mesh=group),
   device="cuda")`` (every count zeroed just before the fit and read just
   after: per round the slice step's 24 ``segment_spmm`` / 2
   ``banded_ttm`` / 2 ``banded_ttm_t`` / 0 ``flash_decode`` and 16 CSR
   builds, 8 all-to-alls of one layer's (8, N, 6) f32 payload, none of it
   leaving the rank), its loss stream held to the single-device
   ``train_streamed(slice_len=8)`` at rtol 1e-5; on the rank's cached
   stream: the prefetch thread off (identical), ``pipeline_rounds`` and
   ``a2a_chunks = 2`` (rtol 1e-5), ``int8_a2a`` and ``int8_all`` (within
   1e-3 of ``none``, ``tests/test_compression_drift.py``'s bound; their
   int8 all-to-all bytes), a fenced run (the round's transfer, CSR pair
   and step), ``pipeline_rounds`` off and on in turns, peak memory; one
   layer's int8 all-to-all, its quantize and dequantize passes apart,
   beside the f32 one and their copy bounds;
4i. P = 2 ranks sharing the card over gloo with CUDA tensors: two
   spawned processes run the distributed stream (TM-GCN, N = 65,536, T =
   8, block 4) on cuda:0, then on the CPU, for ``none`` and ``int8_a2a``;
   their losses held to each other, to the CPU's (1e-4 relative) and to
   the card's P = 1 (``none`` 1e-4 relative, ``int8_a2a`` 1e-3);
4j. the hybrid scheme (paper §6.5) on a 1 x 1 grid of the one-rank NCCL
   group (``dist.sharding.make_grid``): ``paper_dyngnn``'s widths on the
   train phase's trace (made here when that phase does not run), its
   edges split into the grid's destination shard, through
   ``core.hybrid.hybrid_forward`` (every count zeroed just before and read
   just after: L T = 64 ``segment_spmm`` on rectangular CSRs, L = 2
   ``banded_ttm``, T = 32 CSR builds), Z held to ``models.forward`` on the
   same batch (1e-5; 0.0 expected), the forward timed in turns beside the
   eager one; the one-rank frame all-gather at (32, 755,200, 6) into one
   tensor and into a list of its views, beside one copy of the frame;
   ``segment_spmm`` on a rectangular CSR at a Pm = 4 rank's shape
   (188,800 rows gathered from 755,200) at F = 2 and 6, held to its
   plain version, shown to reject zeros and a dropped edge per row, timed
   beside its bound (the x rows the CSR reads), plain version and
   ``torch.sparse.mm``; then a 2 x 2
   grid of four spawned gloo ranks sharing cuda:0 at N = 65,536, T = 8,
   held to CPU gloo and to the card's 1 x 1 grid and eager forward (1e-4);
4k. the sampled schedule over the one-rank NCCL group: ``paper_dyngnn``
   on the train trace (N = 755,200, T = 32; 2 epochs of 4 rounds of
   block 8), the launcher's defaults (N / 4 seeds, fanouts 10, 10), the
   union capped at the largest snapshot's edges, through
   ``Engine(plan=ExecutionPlan(mode="sampled", mesh=group,
   device_budget_bytes=B))`` with B between the sampled and the full-graph
   round's bytes, after ``streamed_mesh`` is shown to refuse B (every
   count zeroed just before the fit and read just after: per round 24 /
   2 / 2 / 0 and 16 CSR builds); ``table_pad``, ``edge_pad``, the dropped
   lanes, per round the fenced host sampling, staging, carry gather /
   all-gather / scatter, step and CSR-pair spans, the staged bytes beside
   the full round's and the peak beside ``sampled_round_bytes``; every
   vertex a seed with full fanout at N = 65,536, T = 8, 2 epochs, against
   the distributed stream on the card (rtol 1e-5); and two spawned gloo
   ranks sharing cuda:0 for 2 epochs, card against CPU and the card's P =
   1 (1e-4);
4l. fault tolerance and elastic rescale (the ft group): eager
   ``paper_dyngnn`` at full width through ``Engine(device="cuda")`` with
   ``CheckpointSpec(every=5)``, 5 steps and ``Engine.resume()`` to 10,
   against the uninterrupted 10-step run and the train phase's losses
   (rtol 1e-5; 160 / 12 / 8 / 0 launches a step); the distributed stream
   at P = 1 over the NCCL group with ``CheckpointSpec(every=2)``, a
   SIGTERM raised in this process through the Engine's ``log_fn`` in
   round 2 (the run stops at cursor 3, mid-epoch) and ``resume()`` to the
   end, against the uninterrupted run (rtol 1e-5; 24 / 2 / 2 / 0 and 16
   CSR builds a round); each beside a cold and a warm ``Checkpointer``
   save's blocking ms and write s, the bytes on disk and a restore; P = 2
   -> 1 -> 2 on two spawned gloo ranks sharing cuda:0 at N = 65,536, T =
   8, against ``train_streamed`` on the card (rtol 1e-5), payloads by
   ``comm_volume.rescale_payload``; the launcher with ``--ckpt-dir`` as a
   subprocess (eager at the smoke config: the distributed stream needs a
   card a rank) stopped by a real SIGTERM after its first logged step,
   exiting 0 with a checkpoint, and relaunched to the uninterrupted
   run's final loss;
5. the LM path: Yi-6B at full width (32 layers, d 4096, 32 query heads
   over 4 KV heads, D 128, bf16, random weights drawn on the card from a
   seed) served through ``ServeEngine(device="cuda").generate()``: one
   wave of 8 prompts of 4,096 tokens (prefill takes the query-chunked
   path), 64 greedy tokens; every kernel's count is zeroed just before
   and read just after (32 layers x 63 decode steps = 2,016 launches of
   ``flash_decode``, none of the dyngnn kernels); prefill ms, decode ms
   per step (fenced spans), tokens/s, peak device memory; then one decode
   step alone and under ``torch.profiler``;
6. ``flash_decode`` held to its plain version at the path's shape (B 8,
   S 4,160, ragged ``cache_len`` with 1 and S), at ``decode_32k``'s
   (S 32,768) and ``long_500k``'s (B 1, S 524,288) lengths, at D 64 and
   D 256 with G 1 (MiniCPM, Gemma), at G 2 (a head tile of 16, 14
   padded), with a ``cache_len = 0`` row and at D 64 with G 4, each in
   bf16 (G > 1 on the tensor-core instance) and f32 (CUDA cores); at
   each, the check is shown to reject zeros and the kernel's output with
   one split's rows dropped; each timed beside its bound, its plain
   version and ``scaled_dot_product_attention`` (a yardstick the port
   never calls);
7. Yi-6B's full widths at 2 layers in f32, card (kernel) against a
   ``device="cpu"`` engine's parameters (plain version): prefill logits
   and 8 teacher-forced decode steps' logits.

Tolerances: segment SpMM 1e-4 (abs and rel; fp32 sums in another order
than the plain ``index_add_``), banded TTM and its transpose 1e-5 (abs
and rel; the same fp32 operations in the same order, so 0.0 is
expected), served scores 1e-4 (the whole stack,
two layers); training loss and gradients 1e-4 x each leaf's max |value|
(sums over T x N ~ 1 M node-steps in another order);
flash decode, against the plain version's fp32 result, batch row by batch
row: 1e-4 abs and rel in f32 (``tests/test_kernels.py``'s), and in bf16
1e-2 x the row's max |plain|, no absolute term (2.56 times the worst
rounding of a bf16 output, 2^-8 of its size; the output shrinks as
1 / sqrt(cache rows), so a fixed term would pass zeros at long caches); LM logits 1e-4 (abs and rel; fp32 sums
of 4,096- and 11,008-long products taken in another order, TF32 off).
Kernel times are device time only (each call queued behind a device
sleep); ``wrapper_ms`` is the wrapper's host time plus device time.

Prints the card line, the per-phase numbers, one JSON line each of the
streamed, the partitioned, the distributed-stream, the hybrid, the
sampled and the fault-tolerance phases' numbers, one JSON line of the
kernels and, last, ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository around it, it exits non-zero and prints no result.  ``--only
serve,train,stream,partition,dstream,hybrid,sampled,ft,lm`` runs the
build and the named groups of phases (1–4, 4a–4c, 4d, 4e–4g, 4h–4i, 4j,
4k, 4l, 5–7; partition is held to train's run, so it needs train) and
prints no result line.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

TOL_SPMM = 1e-4
TOL_TTM = 1e-5
TOL_SCORES = 1e-4
TOL_FD = {"float32": 1e-4, "bfloat16": 1e-2}
TOL_LOGITS = 1e-4

NUM_EVENTS = 3_400_000       # ~2.0 M alive edges at the last window
NUM_WINDOWS = 16
BLOCK_SIZE = 8
QUERY_REPS = 30

TRAIN_T = 32                 # cut from the epinions trace's 512 steps
FULL_T = 512                 # the full config's T: its blocks are timed
TRAIN_DENSITY = 1.25         # smoothed snapshots + self-loops ~ 2.1 M slots
TRAIN_STEPS = 10
TRAIN_NB = 4                 # the full config's checkpoint_blocks
TOL_GRAD = 1e-4
PARITY_N, PARITY_T = 65_536, 16
STREAM_SLICE = 8             # the slice schedule's k: T / 8 AdamW steps
STREAM_PARITY_N, STREAM_PARITY_T = 65_536, 8
PART_P4 = 4                  # the rank count whose per-rank shapes are timed
PART_SHARED_N, PART_SHARED_T, PART_SHARED_NB = 65_536, 8, 2
PART_SHARED_STEPS = 4
RANK_DEADLINE_S = 300        # a spawned rank that hangs fails its phase
DSTREAM_EPOCHS = 2           # the distributed stream: 4 rounds an epoch
DSTREAM_PAIRS = 3            # pipeline_rounds off / on, 1-epoch turns
DSTREAM_SHARED_N, DSTREAM_SHARED_T, DSTREAM_SHARED_NB = 65_536, 8, 2
DRIFT_ATOL = 1e-3            # tests/test_compression_drift.py:43
HYBRID_REPS = 4              # the forward timed in turns with the eager one
HYBRID_SHARED_N, HYBRID_SHARED_T = 65_536, 8
SAMPLED_BLOCK = 8            # the train trace's T = 32: 4 rounds an epoch
SAMPLED_EPOCHS = 2
SAMPLED_SMALL_N, SAMPLED_SMALL_T, SAMPLED_SMALL_BLOCK = 65_536, 8, 4
SAMPLED_SMALL_EPOCHS = 2     # the carry store's epoch reset runs too
FT_EVERY = 5                 # eager: 5 steps, checkpoint, resume() to 10
FT_STREAM_EVERY = 2          # streamed_mesh: a checkpoint every 2 rounds
FT_SIGTERM_ROUND = 2         # ... and a SIGTERM in round 2: cursor 3
FT_SHARED_N, FT_SHARED_T, FT_SHARED_NB = 65_536, 8, 2
FT_SCHEDULE = ((1, 1), (3, 2))   # widths 2 -> 1 -> 2, both mid-epoch
FT_LAUNCH_STEPS = 400        # the launcher at the smoke config

LM_BATCH = 8
LM_PROMPT = 4096
LM_TOKENS = 64


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# ------------------------------------------------------------ timing -------

class Timer:
    """Median CUDA-event time of ``fn`` over repeated calls, with the L2
    cache flushed before each call (the main path finds its inputs cold).
    The flush reads 64 MB, so L2 is left full of clean lines, as the ops
    before a kernel on the path leave it (weights read by the projections,
    say).  ``flush="write"`` zeroes 64 MB instead, as this script's timer
    once did: the timed call then also writes the flush's dirty lines
    back, which no caller on the path makes it do; it is kept to compare
    with readings taken that way.

    By default each call is queued behind a ~0.6 ms device sleep, so the
    host time a wrapper spends before its launch is hidden: the reading is
    device time only.  With ``host=True`` the device is idle when the
    start event is recorded, so the reading is the wrapper's host time
    before its launch plus the device time."""

    def __init__(self, torch, reps: int = 20):
        self.torch = torch
        self.reps = reps
        self._read = torch.ones(16 << 20, dtype=torch.float32,
                                device="cuda")
        self._write = torch.empty(64 << 20, dtype=torch.uint8,
                                  device="cuda")

    def _once(self, fn, host: bool, flush: str) -> float:
        torch = self.torch
        if flush == "read":
            self._read.sum()
        else:
            self._write.zero_()
        if host:
            torch.cuda.synchronize()
        else:
            torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def __call__(self, fn, host: bool = False, flush: str = "read"
                 ) -> float:
        for _ in range(3):
            fn()
        return statistics.median(self._once(fn, host, flush)
                                 for _ in range(self.reps))

    def turns(self, fns: dict) -> dict:
        """Device time of each of ``fns``, the calls taken in turns (a,
        b, a, b, ...) so the card's drift falls on all alike ->
        {name: median ms}."""
        for fn in fns.values():
            for _ in range(3):
                fn()
        times = {k: [] for k in fns}
        for _ in range(self.reps):
            for k, fn in fns.items():
                times[k].append(self._once(fn, False, "read"))
        return {k: statistics.median(v) for k, v in times.items()}


def bound_ms(nbytes: float, flops: float, peak_flops: float = 67e12,
             bw: float = 3.35e12) -> tuple[float, str]:
    """Least time on an H100 SXM (3.35 TB/s; fp32 outside the tensor cores
    67 TFLOP/s): the larger of bytes / bandwidth and ops / peak."""
    t_b, t_f = nbytes / bw * 1e3, flops / peak_flops * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def alternating_walls(torch, variants: dict, rounds: int, warm: int = 1
                      ) -> dict:
    """Host-clock ms of each variant's call (ending in a sync), the
    variants taken in turns so the host's drift falls on all alike ->
    {name: median over rounds - warm}."""
    walls = {k: [] for k in variants}
    for _ in range(rounds):
        for k, fn in variants.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[k].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v[warm:]) for k, v in walls.items()}


def device_profile(torch, fn, ranges: dict | None = None,
                   host_top: list | None = None
                   ) -> tuple[float, float, dict]:
    """``fn()`` once under ``torch.profiler`` -> (wall us, device busy us,
    {device activity name: [us, ...]}).  Device activities only (kernels,
    copies, sets): one stream at a time, so their durations add up to the
    device's busy time without overlap.  The ranges that annotate device
    work (NCCL's ``nccl:all_to_all`` spans its copy) are not activities:
    they go to ``ranges`` ({name: [us, ...]}) when it is given; the 15
    host operations of most self time to ``host_top`` ([(name, us,
    calls)]), when it is given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, list[float]] = {}
    ranges = {} if ranges is None else ranges
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            annotation = (getattr(e, "is_user_annotation", False)
                          or e.name.startswith("nccl:"))
            (ranges if annotation else by_name).setdefault(
                e.name, []).append(e.time_range.elapsed_us())
    busy = sum(sum(v) for v in by_name.values())
    if busy <= 0:
        raise SystemExit("profile: the trace holds no device time")
    if host_top is not None:
        host_top.extend(sorted(
            ((a.key, a.self_cpu_time_total, a.count)
             for a in prof.key_averages()), key=lambda r: -r[1])[:15])
    return wall_us, busy, by_name


#: device activities by kind, first match wins (substrings of the names)
KINDS = (("banded_ttm_t", ("banded_ttm_t",)),
         ("banded_ttm", ("banded_ttm",)),
         ("segment_spmm", ("spmm",)),
         ("flash_decode", ("flash_decode",)),
         ("GEMMs", ("gemm", "xmma", "cutlass")),
         ("stack / cat copies", ("CatArrayBatchedCopy",)),
         ("other copies", ("copy", "Memcpy")),
         ("fills", ("FillFunctor", "Memset")),
         ("gradient adds", ("CUDAFunctor_add",)))


def by_kind(by_name: dict) -> dict:
    """{device activity name: [us]} -> {kind: {"ms", "count"}}; what no
    kind names is "other"."""
    out = {k: {"ms": 0.0, "count": 0} for k, _ in KINDS + (("other", ()),)}
    for name, v in by_name.items():
        kind = next((k for k, subs in KINDS if any(x in name for x in subs)),
                    "other")
        out[kind]["ms"] += sum(v) / 1e3
        out[kind]["count"] += len(v)
    return out


# ------------------------------------------------------------ serving ------

def serve_run(device: str, params, n: int, events, max_edges: int,
              num_windows: int):
    """Push each window's events, advance it; -> (engine, per-window ms)."""
    from repro_torch.configs import registry
    from repro_torch.core.ctdg import EventStream
    from repro_torch.serve import IngestSpec, ServeConfig, ServeEngine

    spec = IngestSpec(num_windows=num_windows, policy="snapshot",
                      time_range=(float(events.time.min()),
                                  float(events.time.max())),
                      block_size=BLOCK_SIZE, max_edges=max_edges)
    cfg = dataclasses.replace(
        registry.get_arch("paper_dyngnn").make_config(), num_nodes=n)
    eng = ServeEngine(ServeConfig(arch="paper_dyngnn", model=cfg,
                                  ingest=spec), params=params,
                      device=device)
    win = spec.window_of(events.time)
    cuts = [0] + [int((win <= k).sum()) for k in range(num_windows)]
    advance_ms = []
    for k in range(num_windows):
        sl = slice(cuts[k], cuts[k + 1])
        eng.ingest(EventStream(events.src[sl], events.dst[sl],
                               events.time[sl], events.kind[sl], n))
        t0 = time.perf_counter()
        eng.advance(1)
        advance_ms.append((time.perf_counter() - t0) * 1e3)
    return eng, advance_ms


def percentiles(ms: list[float]) -> str:
    return (f"p50 {statistics.median(ms):.3f} ms, "
            f"p95 {sorted(ms)[int(0.95 * (len(ms) - 1))]:.3f} ms")


def check_launches(path: str, launches: dict, want: dict) -> None:
    log(f"[{path}] launches on the path: {launches}")
    for name, n in want.items():
        if launches[name] != n:
            raise SystemExit(f"kernel {name}: {launches[name]} launches on "
                             f"the {path} path, expected {n}")


def main_path(torch, kernels, obs, n_nodes: int, max_edges: int):
    """Phase 2: the full-width serving run on the kernel path."""
    import numpy as np

    from repro_torch.core.ctdg import synthetic_ctdg
    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops

    t0 = time.perf_counter()
    events = synthetic_ctdg(n_nodes, NUM_EVENTS, delete_frac=0.2, seed=0)
    log(f"[serve] {len(events)} events generated on the host in "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    tracer = obs.configure(enabled=True)     # fenced phase spans
    reset_counts(kernels)
    spmm_ops.csr_builds = 0
    eng, advance_ms = serve_run("cuda", None, n_nodes, events, max_edges,
                                NUM_WINDOWS)
    launches = {k.name: k.launches for k in kernels}
    builds = spmm_ops.csr_builds
    obs.configure(enabled=False)
    check_launches("serve", launches, {"segment_spmm": 2 * NUM_WINDOWS,
                                       "banded_ttm": 2 * NUM_WINDOWS,
                                       "banded_ttm_t": 0,
                                       "flash_decode": 0})
    log(f"[serve] CSR builds on the path: {builds} (one per snapshot; "
        f"{launches['segment_spmm']} segment_spmm launches read them)")
    if builds != NUM_WINDOWS:
        raise SystemExit(f"segment_spmm: {builds} CSR builds in "
                         f"{NUM_WINDOWS} windows, expected {NUM_WINDOWS}")
    launches["csr_builds"] = builds
    alive = int(eng.applier.current[1].sum())
    r = eng.result()
    log(f"[serve] windows={r.windows_advanced} alive edges at the last "
        f"window={alive} resyncs={r.resyncs}")
    log(f"[serve] ingest+advance {r.ingest_seconds:.3f} s -> "
        f"{r.events_per_s:.0f} events/s")
    log("[serve] advance ms per window: "
        + ", ".join(f"{v:.1f}" for v in advance_ms))
    phases = {}
    for sp in tracer.spans():
        phases.setdefault(sp.name, []).append(sp.dur_s * 1e3)
    log("[serve] per-window phases (fenced spans, median / max ms): "
        + ", ".join(f"{name.split('.')[-1]} "
                    f"{statistics.median(phases[name]):.1f} / "
                    f"{max(phases[name]):.1f}"
                    for name in ("serve.encode", "serve.stage",
                                 "serve.apply", "serve.step")))
    log(f"[serve] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")

    rng = np.random.default_rng(1)
    for b in (1, 8, 64):
        lat = []
        for _ in range(QUERY_REPS):
            ids = rng.integers(0, n_nodes, b)
            t0 = time.perf_counter()
            out = eng.query_nodes(ids)
            lat.append((time.perf_counter() - t0) * 1e3)
            if out.shape != (b, 2) or not np.isfinite(out).all():
                raise SystemExit(f"query_nodes batch {b}: bad scores "
                                 f"{out.shape}")
        log(f"[query] nodes batch {b}: {percentiles(lat)}")
    lat = []
    for _ in range(QUERY_REPS):
        pairs = rng.integers(0, n_nodes, (64, 2))
        t0 = time.perf_counter()
        out = eng.query_links(pairs)
        lat.append((time.perf_counter() - t0) * 1e3)
        if out.shape != (64, 2) or not np.isfinite(out).all():
            raise SystemExit(f"query_links: bad logits {out.shape}")
    log(f"[query] links 64 pairs: {percentiles(lat)}")
    return eng, events, launches


# ------------------------------------------------------- kernel checks -----

def check_close(name: str, got, want, tol: float) -> float:
    err = float((got - want).abs().max())
    limit = tol + tol * float(want.abs().max())
    if not (err <= limit):
        raise SystemExit(f"{name}: kernel disagrees with its plain version:"
                         f" max |diff| {err:.3e} > {limit:.3e}")
    return err


def spmm_faults(name: str, ops, x, row_ptr, col, w, want
                ) -> dict:
    """Show that the segment SpMM check rejects two faulty outputs made on
    the card: zeros, and the kernel run with each row's last edge dropped
    (its weight set to 0) -> {fault: max |diff| over the limit}."""
    last = row_ptr[1:] - 1
    last = last[row_ptr[1:] > row_ptr[:-1]].long()
    w_cut = w.clone()
    w_cut[last] = 0.0
    limit = TOL_SPMM * (1.0 + float(want.abs().max()))
    faults = {
        "zeros": float(want.abs().max()) / limit,
        "last edge dropped": float((ops.segment_spmm_csr(
            x, row_ptr, col, w_cut) - want).abs().max()) / limit}
    for fault, ratio in faults.items():
        if ratio <= 1.0:
            raise SystemExit(f"segment_spmm {name}: the check would pass a "
                             f"kernel that wrote {fault} ({ratio:.3f} x "
                             "its limit)")
    return faults


def check_spmm(torch, eng, timer):
    """Segment SpMM on the last window's graph (with self-loops), at the
    path's F = 2 (layer 1) and 6 (layer 2) and the generic instance's
    F = 9 and 32, then on a fully skewed graph; each held to the plain
    version, shown to reject two faulty outputs, and timed."""
    from repro_torch.graph import segment
    from repro_torch.kernels.segment_spmm import ops, ref
    from repro_torch.stream.train_loop import (make_self_loops,
                                               slice_weights_with_loops)

    n = eng.model.num_nodes
    edges, mask = eng.applier.current
    # snapshot policy: every valid lane's value is 1, so values == mask
    e_full, w_full = slice_weights_with_loops(
        n, *make_self_loops(n, edges.device), edges[None], mask[None],
        mask[None])
    e, w = e_full[0], w_full[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    valid = w != 0
    deg = torch.stack([segment.in_degree(e, n, valid),
                       segment.out_degree(e, n, valid)], dim=1)
    row_ptr, col, wc = ops.build_csr(e, w, n)
    nnz = int(row_ptr[-1])
    results = []
    err_all = 0.0
    build_ms = timer(lambda: ops.build_csr(e, w, n))
    for f, x in ((2, deg.contiguous()),
                 (6, torch.randn((n, 6), generator=gen, device="cuda")),
                 (9, torch.randn((n, 9), generator=gen, device="cuda")),
                 (32, torch.randn((n, 32), generator=gen, device="cuda"))):
        got = ops.segment_spmm_csr(x, row_ptr, col, wc)
        want = ref.segment_spmm_csr_ref(x, row_ptr, col, wc)
        torch.cuda.synchronize()
        err = check_close(f"segment_spmm F={f}", got, want, TOL_SPMM)
        faults = spmm_faults(f"F={f}", ops, x, row_ptr, col, wc,
                             want)
        err_all = max(err_all, err)
        csr = torch.sparse_csr_tensor(row_ptr, col[:nnz], wc[:nnz],
                                      size=(n, n), check_invariants=False)
        lib_err = float((torch.sparse.mm(csr, x) - want).abs().max())
        nbytes = (x.nbytes + row_ptr.nbytes + nnz * 8 + got.nbytes)
        b_ms, b_by = bound_ms(nbytes, 2.0 * nnz * f)

        def kern(x=x):
            return ops.segment_spmm_csr(x, row_ptr, col, wc)

        row = {
            "F": f, "edges": int(e.shape[0]), "nnz": nnz,
            "ms": timer(kern), "wrapper_ms": timer(kern, host=True),
            "with_csr_ms": timer(lambda x=x: ops.segment_spmm(x, e, w, n)),
            "with_csr_wrapper_ms": timer(
                lambda x=x: ops.segment_spmm(x, e, w, n), host=True),
            "csr_build_ms": build_ms,
            "plain_ms": timer(lambda x=x: ref.segment_spmm_csr_ref(
                x, row_ptr, col, wc)),
            "library_ms": timer(lambda x=x, csr=csr: torch.sparse.mm(csr,
                                                                     x)),
            "ms_write_flush": timer(kern, flush="write"),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            "fault_over_limit": faults,
            "library_max_abs_err": lib_err}
        log(f"[kernel] segment_spmm F={f}: kernel {row['ms']:.4f} ms "
            f"(wrapper, host + device {row['wrapper_ms']:.4f}; with its "
            f"CSR build {row['with_csr_ms']:.4f}, wrapper "
            f"{row['with_csr_wrapper_ms']:.4f}), CSR build {build_ms:.4f}, "
            f"plain {row['plain_ms']:.4f}, torch.sparse.mm "
            f"{row['library_ms']:.4f}, bound {b_ms:.4f} ({b_by}); with "
            f"a write flush: kernel {row['ms_write_flush']:.4f}")
        log(f"[kernel]   max|err| {err:.2e}; faults rejected at x limit: "
            f"zeros {faults['zeros']:.1f}, last edge dropped "
            f"{faults['last edge dropped']:.1f}")
        results.append(row)
    # fully skewed: every edge into one destination, pad lanes at (0, 0);
    # weights in [0.5, 1), so the one dropped edge of the fault below
    # stands out of a row summed over 32 K edges
    m = 1 << 16
    src = torch.randint(0, n, (m,), generator=gen, device="cuda")
    sk = torch.stack([src, torch.full_like(src, 7)], 1).to(torch.int32)
    sw = 0.5 + 0.5 * torch.rand((m,), generator=gen, device="cuda")
    sw[m // 2:] = 0.0
    sk[m // 2:] = 0
    s_csr = ops.build_csr(sk, sw, n)
    skew_err, skew_rows = 0.0, []
    for f in (2, 6, 9, 32):
        x = torch.randn((n, f), generator=gen, device="cuda")
        got = ops.segment_spmm(x, sk, sw, n)
        want = ref.segment_spmm_csr_ref(x, *s_csr)
        torch.cuda.synchronize()
        err = check_close(f"segment_spmm skewed F={f}", got, want, TOL_SPMM)
        faults = spmm_faults(f"skewed F={f}", ops, x, *s_csr, want)
        skew_err = max(skew_err, err)
        row = {"F": f, "max_abs_err": err, "fault_over_limit": faults,
               "ms": timer(lambda x=x: ops.segment_spmm_csr(x, *s_csr))}
        skew_rows.append(row)
        log(f"[kernel] segment_spmm skewed F={f} ({m} lanes into one row, "
            f"half of them zero-weight pads): max|err| {err:.2e}, faults "
            f"rejected at x limit: zeros {faults['zeros']:.1f}, last edge "
            f"dropped {faults['last edge dropped']:.1f}; kernel "
            f"{row['ms']:.4f} ms")
    return results, err_all, skew_err, skew_rows


def band_cost(t_s: int, nf: int, window: int, t_offset: int, lead: int,
              all_rows: bool = False) -> tuple[float, float]:
    """Bytes and operations of the forward M over [prefix (lead rows); x
    (t_s rows)], row 0 at global index ``t_offset``: it reads the rows
    that lie in a kept band, rows max(0, lead - w + 1, -t_offset) on, and
    writes the t_s kept rows; one multiply-add per band entry and column
    of a written row.  ``all_rows``: the earlier contract, which read
    every row from global step 1 on and wrote all lead + t_s rows."""
    rows, step1 = lead + t_s, max(0, -t_offset)
    first = 0 if all_rows else lead
    lo = step1 if all_rows else max(step1, lead - window + 1)
    nnz = sum(t - max(step1, t - window + 1) + 1
              for t in range(max(first, step1), rows))
    read = max(0, rows - lo)
    return float((read + rows - first) * nf * 4), float(nnz * nf)


def band_t_cost(t_s: int, nf: int, window: int, t_offset: int, lead: int,
                first: int) -> tuple[float, float]:
    """Bytes and operations of M^T over the kept rows: dZ (t_s, nf) of
    rows lead .. lead + t_s - 1 of a (lead + t_s)-row tensor, rows
    first .. lead + t_s - 1 written; a dZ row counts when it lies in some
    written band (at or after global step 1 and row first); one
    multiply-add per band entry and column."""
    rows = lead + t_s
    lo = max(first, -t_offset, 0)
    nnz = sum(t - max(lo, t - window + 1) + 1
              for t in range(max(lead, lo), rows))
    read = max(0, rows - max(lead, lo))
    return float((read + rows - first) * nf * 4), float(nnz * nf)


def band_matrix(torch, t: int, window: int, t_offset: int):
    """The dense (t, t) M of ``banded_ttm`` on the card (a yardstick)."""
    m = torch.zeros((t, t), device="cuda")
    for r in range(t):
        g = r + t_offset + 1
        for k in range(max(0, r - window + 1, -t_offset), r + 1):
            m[r, k] = 1.0 / min(window, g)
    return m


def check_ttm(torch, n: int, window: int, timer):
    """``banded_ttm`` at serving's call: the (w - 1)-row prefix carry and
    one new row of N x 6 columns, one row written; at the first window's
    t_offset (-4: the prefix lies before global step 1), 0, 37 and the
    last window's (the main row)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    main_off = NUM_WINDOWS - 1 - (window - 1)   # the last window's prefix
    rows = band_rows(torch, gen, n, window, timer, [
        (1, window - 1, off) for off in (-4, 0, 37, main_off)])
    return dict(rows[-1], max_abs_err=max(r["max_abs_err"] for r in rows),
                offsets=rows)


# ------------------------------------------------------------ profile ------

def profile_step(torch, eng):
    """The state-advance step alone, on the last window's graph: steady
    time over a few repeats, then one step under ``torch.profiler`` for
    device time by kernel and the device's idle share of the step."""
    from repro_torch.graph import segment

    n = eng.model.num_nodes
    edges, mask = eng.applier.current
    frame = torch.stack([segment.in_degree(edges, n, mask),
                         segment.out_degree(edges, n, mask)], dim=1)

    def step():
        carries = [c.clone() for c in eng.carries]
        return eng._advance(eng.params, carries, frame, edges, mask, mask,
                            NUM_WINDOWS)

    steady = alternating_walls(torch, {"step": step}, 7)["step"]
    log(f"[profile] state-advance step (warm, host clock + sync, median of "
        f"6): {steady:.3f} ms")
    wall_us, busy, by_name = device_profile(torch, step)
    log(f"[profile] one step under the profiler: wall {wall_us / 1e3:.2f} "
        f"ms, device busy {busy / 1e3:.2f} ms, idle share "
        f"{1 - busy / wall_us:.3f}, {sum(map(len, by_name.values()))} "
        f"device activities")
    for name, v in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]:
        log(f"[profile]   {sum(v) / 1e3:8.3f} ms  x{len(v):<3d} {name[:90]}")
    return {"steady_ms": steady, "wall_ms": wall_us / 1e3,
            "busy_ms": busy / 1e3, "idle_share": 1 - busy / wall_us}


# ------------------------------------------------------- plain parity ------

def plain_parity(eng, events):
    """The whole run replayed on the CPU, where the kernel wrappers run
    their plain versions: the last window's embeddings and queries, card
    (kernels) against CPU (plain)."""
    import numpy as np

    rng = np.random.default_rng(2)
    n = eng.model.num_nodes
    ids = rng.integers(0, n, 64)
    pairs = rng.integers(0, n, (64, 2))
    got_n, got_l = eng.query_nodes(ids), eng.query_links(pairs)
    plain, _ = serve_run("cpu", eng.params, n, events,
                         eng.applier.max_edges, NUM_WINDOWS)
    z_err = float((eng.z.cpu() - plain.z).abs().max())
    err = max(np.abs(got_n - plain.query_nodes(ids)).max(),
              np.abs(got_l - plain.query_links(pairs)).max())
    if not (err <= TOL_SCORES and z_err <= TOL_SCORES):
        raise SystemExit(f"served state: card (kernels) vs CPU (plain) "
                         f"max |diff| z {z_err:.3e}, scores {err:.3e} > "
                         f"{TOL_SCORES}")
    log(f"[serve] {NUM_WINDOWS} windows replayed on the CPU (plain "
        f"versions): last-window z max |diff| {z_err:.2e}, queries max "
        f"|diff| {err:.2e} (tolerance {TOL_SCORES})")


def small_parity(torch):
    """Small graphs, all three models: card (kernels) vs CPU (plain),
    after every window."""
    import numpy as np

    from repro_torch.core import models as mdl
    from repro_torch.core.ctdg import synthetic_ctdg
    from repro_torch.serve import IngestSpec, ServeConfig, ServeEngine

    n, windows = 40, 12
    ev = synthetic_ctdg(n, 500, delete_frac=0.25, seed=1)
    spec = IngestSpec(num_windows=windows, block_size=4, max_edges=512,
                      time_range=(float(ev.time.min()),
                                  float(ev.time.max())))
    for model in ("tmgcn", "cdgcn", "evolvegcn"):
        cfg = mdl.DynGNNConfig(model=model, num_nodes=n, window=3)
        params = mdl.init_params(torch.Generator().manual_seed(7), cfg)
        gpu = ServeEngine(ServeConfig(model=cfg, ingest=spec),
                          params=params, device="cuda")
        cpu = ServeEngine(ServeConfig(model=cfg, ingest=spec),
                          params=params, device="cpu")
        gpu.ingest(ev)
        cpu.ingest(ev)
        err = 0.0
        for _ in range(windows):
            gpu.advance()
            cpu.advance()
            err = max(err, np.abs(gpu.query_nodes(np.arange(n))
                                  - cpu.query_nodes(np.arange(n))).max())
        if not err <= TOL_SCORES:
            raise SystemExit(f"small {model}: card vs CPU max |diff| "
                             f"{err:.3e} > {TOL_SCORES}")
        log(f"[parity] {model} N={n}: card (kernels) vs CPU (plain), "
            f"{windows} windows, max |diff| {err:.2e}")


# ------------------------------------------------------------ training -----

def train_trace(n_nodes: int, window: int):
    """The training trace's spec: T = 32 steps at N = ``n_nodes``,
    M-transform smoothed (~2.1 M edge slots with self-loops)."""
    from repro_torch.run import SyntheticTrace

    return SyntheticTrace(num_nodes=n_nodes, num_steps=TRAIN_T,
                          density=TRAIN_DENSITY, churn=0.1,
                          smoothing_mode="mproduct", window=window, seed=0)


def train_launches(layers: int, t: int, nb: int) -> dict:
    """Launches of ``TRAIN_STEPS`` blocked TM-GCN steps: per step the
    aggregate forward (L T), again in each block's recompute (L T) and
    backward for every layer but the first (T); the M-product forward
    (L nb), in the recompute up to the block's last saved tensor, layer
    2's relu (nb: early stop), backward (L nb)."""
    return {"segment_spmm": TRAIN_STEPS * (2 * layers * t + t),
            "banded_ttm": TRAIN_STEPS * (layers * nb + nb),
            "banded_ttm_t": TRAIN_STEPS * layers * nb, "flash_decode": 0}


def train_path(torch, kernels, obs, n_nodes: int):
    """The training path: ``paper_dyngnn`` (TM-GCN) at the full config's
    widths through ``repro_torch.run.Engine(device="cuda")`` — 10 AdamW
    steps of the blocked-checkpoint trainer (nb 4) over a T = 32 synthetic
    trace at N = 755,200, then link-prediction evaluation -> (the padded
    batch, the path's numbers, the trace's dataset, which the streamed
    phase trains on again)."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.core import checkpoint as ckpt
    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops
    from repro_torch.run import Engine, ExecutionPlan, RunConfig

    cfg = registry.get_arch("paper_dyngnn").make_config()
    data = train_trace(n_nodes, cfg.window)
    t0 = time.perf_counter()
    eng = Engine(RunConfig(model=cfg, data=data,
                           plan=ExecutionPlan(num_steps=TRAIN_STEPS),
                           log_fn=log), device="cuda")
    rr = eng.resolve()
    pipe, nb = rr.pipeline, rr.cfg.checkpoint_blocks
    log(f"[train] {cfg.model}: trace N={n_nodes}, T={TRAIN_T}, density "
        f"{TRAIN_DENSITY} + M-transform (w {cfg.window}) + self-loops, made "
        f"on the host in {time.perf_counter() - t0:.1f} s: max_edges "
        f"{pipe.max_edges} (DATASETS['epinions']: 2,097,152), graph-diff "
        f"bytes {pipe.transfer_bytes()['ratio']:.3f} of naive")
    t0 = time.perf_counter()
    batch = pipe.batch
    torch.cuda.synchronize()
    batch_bytes = sum(t.nbytes for t in (batch.edges, batch.edge_weights,
                                         batch.edge_mask, batch.frames))
    log(f"[train] padded batch {batch_bytes / 1e9:.3f} GB on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    tracer = obs.configure(enabled=True)     # fenced train.step spans
    reset_counts(kernels)
    spmm_ops.csr_builds = 0
    t0 = time.perf_counter()
    res = eng.fit()
    fit_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    builds = spmm_ops.csr_builds
    obs.configure(enabled=False)
    peak = torch.cuda.max_memory_allocated()
    layers, t = cfg.num_layers, TRAIN_T
    check_launches("train", launches, train_launches(layers, t, nb))
    log(f"[train] CSR builds: {builds} (a forward and a transposed CSR per "
        "snapshot, once per run)")
    if builds != 2 * t:
        raise SystemExit(f"train: {builds} CSR builds, expected {2 * t}")
    launches["csr_builds"] = builds
    losses = res.losses
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise SystemExit(f"train: bad losses {losses}")
    spans = tracer.spans()
    step_ms = [sp.dur_s * 1e3 for sp in spans if sp.name == "train.step"]
    build_ms = [sp.dur_s * 1e3 for sp in spans
                if sp.name == "train.csr_build"]
    if len(step_ms) != TRAIN_STEPS or len(build_ms) != 1:
        raise SystemExit(f"train: {len(step_ms)} train.step spans, "
                         f"{len(build_ms)} train.csr_build spans")
    est = ckpt.activation_memory_estimate(rr.cfg, pipe.max_edges, nb)
    csr_bytes = sum(x.nbytes for pair in batch.csr_pairs() for c in pair
                    for x in c)
    log("[train] losses: " + ", ".join(f"{v:.5f}" for v in losses))
    log(f"[train] fit {fit_s:.2f} s; train.step (fenced spans): first "
        f"{step_ms[0]:.1f} ms (of which the 2 T CSR builds, fenced, "
        f"{build_ms[0]:.1f} ms), median of the rest "
        f"{statistics.median(step_ms[1:]):.1f} ms, median of all "
        f"{statistics.median(step_ms):.1f} ms")
    log(f"[train] peak device memory {peak / 2**30:.3f} GiB "
        f"({peak / 1e9:.3f} GB): batch {batch_bytes / 1e9:.3f} GB, CSR "
        f"pairs {csr_bytes / 1e9:.3f} GB; activation_memory_estimate(nb "
        f"{nb}) total {est['total'] / 1e9:.3f} GB (intra-block "
        f"{est['intra_block'] / 1e9:.3f}, checkpoints "
        f"{est['checkpoint'] / 1e9:.3f})")
    t0 = time.perf_counter()
    acc = eng.evaluate(res)
    log(f"[train] link-pred acc {acc:.3f} ({time.perf_counter() - t0:.1f} "
        "s)")

    step_fn = rr.cache["eager_step"]
    labels = torch.from_numpy(rr.ds.labels).cuda()
    state = {"params": res.state.params, "opt": res.state.opt_state}

    def one_step():
        state["params"], state["opt"], _ = step_fn(
            state["params"], state["opt"], batch, labels)

    steady = alternating_walls(torch, {"step": one_step}, 7)["step"]
    log(f"[profile-train] warm step (host clock + sync, median of 6): "
        f"{steady:.1f} ms")
    host_top: list = []
    wall_us, busy, by_name = device_profile(torch, one_step,
                                            host_top=host_top)
    kinds = by_kind(by_name)
    # the forward M-product reads [prefix, slice] where they lie: its
    # device time is its kernel's alone
    fwd = kinds["banded_ttm"]
    prof = {"steady_ms": steady, "wall_ms": wall_us / 1e3,
            "busy_ms": busy / 1e3, "idle_share": 1 - busy / wall_us,
            "activities": sum(map(len, by_name.values())), "by_kind": kinds,
            "host_top": host_top,
            "forward_mproduct_ms": fwd["ms"],
            "forward_mproduct_launches": fwd["count"]}
    log(f"[profile-train] one step under the profiler: wall "
        f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms, idle "
        f"share {1 - busy / wall_us:.3f}, {prof['activities']} device "
        f"activities; the forward M-product {fwd['ms']:.3f} ms in "
        f"{fwd['count']} banded_ttm launches, no copy")
    for name, v in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]:
        log(f"[profile-train]   {sum(v) / 1e3:8.3f} ms  x{len(v):<4d} "
            f"{name[:90]}")
    log("[profile-train] device time by kind, ms (launches):")
    for kind, v in kinds.items():
        log(f"[profile-train]   {kind:20s} {v['ms']:8.3f} ({v['count']:4d})")
    stats = {"losses": losses, "step_ms": step_ms,
             "step_ms_median": statistics.median(step_ms),
             "step_ms_median_after_first": statistics.median(step_ms[1:]),
             "csr_build_ms": build_ms[0],
             "fit_s": fit_s, "peak_bytes": peak, "batch_bytes": batch_bytes,
             "csr_bytes": csr_bytes, "activation_estimate": est,
             "max_edges": pipe.max_edges, "link_pred_acc": acc,
             "launches": launches, "profile": prof}
    return batch, stats, rr.ds


def check_backward(torch, batch, n: int, window: int, timer):
    """The kernels at the train path's shapes, held to their plain
    versions, each shown to reject faulty outputs, and timed beside its
    bound, its plain version and its library call: ``segment_spmm`` on the
    last snapshot's transposed CSR at F = 6 (the backward); ``banded_ttm``
    (forward and recompute) on the blocks' [prefix (w - 1 rows); slice
    (bsize rows)] with t_offset -4 (block 0) and +4 (block 1; blocks 2 and
    3 read the same full band at +12, +20), on (T, N x 6) over an empty
    prefix and on the full config's block; ``banded_ttm_t`` (the backward)
    at the same four; then both bands' sweeps at small shapes."""
    from repro_torch.kernels.segment_spmm import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(6)
    row_ptr, col, w = batch.csr_pairs()[-1][1]
    nnz = int(row_ptr[-1])
    dy = torch.randn((n, 6), generator=gen, device="cuda")
    got = ops.segment_spmm_csr(dy, row_ptr, col, w)
    want = ref.segment_spmm_csr_ref(dy, row_ptr, col, w)
    torch.cuda.synchronize()
    err = check_close("segment_spmm on the transposed CSR F=6", got, want,
                      TOL_SPMM)
    faults = spmm_faults("transposed F=6", ops, dy, row_ptr, col, w, want)
    lib = torch.sparse_csr_tensor(row_ptr, col[:nnz], w[:nnz], size=(n, n),
                                  check_invariants=False)
    b_ms, b_by = bound_ms(dy.nbytes + row_ptr.nbytes + nnz * 8 + got.nbytes,
                          2.0 * nnz * 6)

    def kern():
        return ops.segment_spmm_csr(dy, row_ptr, col, w)

    spmm = {"F": 6, "nnz": nnz, "ms": timer(kern),
            "wrapper_ms": timer(kern, host=True),
            "plain_ms": timer(lambda: ref.segment_spmm_csr_ref(
                dy, row_ptr, col, w)),
            "library_ms": timer(lambda: torch.sparse.mm(lib, dy)),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            "fault_over_limit": faults}
    log(f"[kernel] segment_spmm backward (transposed CSR, {nnz} edges) F=6:"
        f" kernel {spmm['ms']:.4f} ms (wrapper {spmm['wrapper_ms']:.4f}), "
        f"plain {spmm['plain_ms']:.4f}, torch.sparse.mm on A^T "
        f"{spmm['library_ms']:.4f}, bound {b_ms:.4f} ({b_by}); max|err| "
        f"{err:.2e}; faults rejected at x limit: zeros "
        f"{faults['zeros']:.1f}, last edge dropped "
        f"{faults['last edge dropped']:.1f}")

    bsize, w1 = TRAIN_T // TRAIN_NB, window - 1
    full_bsize = FULL_T // TRAIN_NB
    # (T_s, lead, t_offset of prefix row 0): block 0, block 1 (blocks 2
    # and 3 read the same full band at +12, +20), the whole T over an
    # empty prefix, and block 1 of the full config's T = 512
    fwd = band_rows(torch, gen, n, window, timer, (
        (bsize, w1, -w1), (bsize, w1, bsize - w1), (TRAIN_T, 0, 0),
        (full_bsize, w1, full_bsize - w1)))
    # (T_s, lead, t_offset, write_lead): the gradient of block 0's kept
    # rows (its prefix, the zero initial carry, needs none), of block 1's
    # (prefix and slice), of the whole T, and of the full config's block 1
    rows = band_t_rows(torch, gen, n, window, timer, (
        (bsize, w1, -w1, False), (bsize, w1, bsize - w1, True),
        (TRAIN_T, 0, 0, True), (full_bsize, w1, full_bsize - w1, True)))
    return (spmm, fwd, rows, band_sweep(torch, gen),
            band_t_sweep(torch, gen))


def reject_faults(name: str, want, limit: float, faulty: dict) -> dict:
    """Show that a band check rejects each faulty output of ``faulty``
    ({fault: output, or None where the fault cannot arise}) -> {fault:
    max |diff| over the limit, or None}."""
    ratios = {"zeros": float(want.abs().max()) / limit}
    for fault, out in faulty.items():
        ratios[fault] = None if out is None else \
            float((out - want).abs().max()) / limit
    for fault, ratio in ratios.items():
        if ratio is not None and ratio <= 1.0:
            raise SystemExit(f"{name}: the check would pass a kernel that "
                             f"wrote {fault} ({ratio:.3f} x its limit)")
    return ratios


def without_row(x, row: int):
    cut = x.clone()
    cut[row] = 0.0
    return cut


def fault_text(faults: dict) -> str:
    return ", ".join(f"{k} " + ("n/a" if v is None else f"{v:.1f}")
                     for k, v in faults.items())


def band_rows(torch, gen, n: int, window: int, timer, cases) -> list[dict]:
    """``banded_ttm`` on [prefix (lead, N x 6); x (T_s, N x 6)] at each
    (T_s, lead, t_offset of prefix row 0) of ``cases``: held to its plain
    version, shown to reject zeros, a dropped prefix row (the last, which
    lies in the first kept row's band; n/a without a prefix, or when the
    prefix lies before global step 1 and is never read) and a dropped
    slice row, and timed beside its bound (the kept rows' count, and the
    earlier all-rows contract's beside it), its plain version and
    cuBLAS's dense band M[lead:] @ [prefix; x] on an input concatenated
    beforehand (the cat left out of its time)."""
    from repro_torch.kernels.mproduct import ops, ref

    rows = []
    for t_s, lead, off in cases:
        prefix = torch.randn((lead, n * 6), generator=gen, device="cuda")
        x = torch.randn((t_s, n * 6), generator=gen, device="cuda")

        def kern(p=prefix, v=x, off=off):
            return ops.banded_ttm(p, v, window, off)

        got = kern()
        want = ref.banded_ttm_ref(prefix, x, window, off)
        torch.cuda.synchronize()
        name = (f"banded_ttm [prefix ({lead}, {n * 6}); x ({t_s}, {n * 6})]"
                f" t_offset={off}")
        err = check_close(name, got, want, TOL_TTM)
        del got
        read_prefix = lead > 0 and lead + off >= 1
        faults = reject_faults(name, want, TOL_TTM * (
            1.0 + float(want.abs().max())), {
                "a prefix row dropped": kern(
                    without_row(prefix, lead - 1)) if read_prefix else None,
                "a slice row dropped": kern(v=without_row(x, t_s // 2))})
        full = torch.cat([prefix, x])
        m = band_matrix(torch, lead + t_s, window, off)[lead:].contiguous()
        b_ms, b_by = bound_ms(*band_cost(t_s, n * 6, window, off, lead))
        old_b_ms, _ = bound_ms(*band_cost(t_s, n * 6, window, off, lead,
                                          all_rows=True))
        row = {"shape": [t_s, n * 6], "lead": lead, "t_offset": off,
               "ms": timer(kern), "wrapper_ms": timer(kern, host=True),
               "plain_ms": timer(lambda p=prefix, v=x, off=off:
                                 ref.banded_ttm_ref(p, v, window, off)),
               "library_ms": timer(lambda m=m, full=full: m @ full),
               "bound_ms": b_ms, "bound_by": b_by,
               "bound_all_rows_ms": old_b_ms, "max_abs_err": err,
               "library_max_abs_err": float((m @ full - want).abs().max()),
               "fault_over_limit": faults}
        log(f"[kernel] {name}: kernel {row['ms']:.4f} ms (wrapper "
            f"{row['wrapper_ms']:.4f}), plain {row['plain_ms']:.4f}, dense "
            f"band M[lead:] @ [prefix; x] {row['library_ms']:.4f}, bound "
            f"{b_ms:.4f} ({b_by}, {b_ms / row['ms']:.1%}; all rows written:"
            f" {old_b_ms:.4f}); max|err| {err:.2e}; faults rejected at x "
            f"limit: {fault_text(faults)}")
        rows.append(row)
        del prefix, x, want, full, m
        torch.cuda.empty_cache()
    return rows


def band_t_rows(torch, gen, n: int, window: int, timer, cases
                ) -> list[dict]:
    """``banded_ttm_t`` on the kept rows' gradient dZ (T_s, N x 6) at each
    (T_s, lead, t_offset, write_lead) of ``cases``: held to its plain
    version, shown to reject zeros and a dropped dZ row, and timed beside
    its bound (the kept-rows contract's bytes), its plain version and the
    dense ``M[lead:, first:]^T @ dZ``."""
    from repro_torch.kernels.mproduct import ops, ref

    rows = []
    for t_s, lead, off, write_lead in cases:
        first = 0 if write_lead else lead
        dz = torch.randn((t_s, n * 6), generator=gen, device="cuda")

        def kern(v=dz, lead=lead, off=off, wl=write_lead):
            return ops.banded_ttm_t(v, window, off, lead, wl)

        got = kern()
        want = ref.banded_ttm_t_ref(dz, window, off, lead, write_lead)
        torch.cuda.synchronize()
        name = (f"banded_ttm_t dZ ({t_s}, {n * 6}) lead {lead} t_offset="
                f"{off}{'' if write_lead else ', slice rows only'}")
        err = check_close(name, got, want, TOL_TTM)
        del got
        faults = reject_faults(name, want, TOL_TTM * (
            1.0 + float(want.abs().max())), {
                "a dZ row dropped": kern(without_row(dz, t_s // 2))})
        m = band_matrix(torch, lead + t_s, window, off)[lead:, first:]
        m = m.T.contiguous()
        b_ms, b_by = bound_ms(*band_t_cost(t_s, n * 6, window, off, lead,
                                           first))
        row = {"shape": [t_s, n * 6], "lead": lead, "t_offset": off,
               "write_lead": write_lead, "ms": timer(kern),
               "wrapper_ms": timer(kern, host=True),
               "plain_ms": timer(lambda v=dz, lead=lead, off=off,
                                 wl=write_lead: ref.banded_ttm_t_ref(
                                     v, window, off, lead, wl)),
               "library_ms": timer(lambda v=dz, m=m: m @ v),
               "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
               "library_max_abs_err": float((m @ dz - want).abs().max()),
               "fault_over_limit": faults}
        log(f"[kernel] {name}: kernel {row['ms']:.4f} ms (wrapper "
            f"{row['wrapper_ms']:.4f}), plain {row['plain_ms']:.4f}, "
            f"dense M^T @ dZ {row['library_ms']:.4f}, bound {b_ms:.4f} "
            f"({b_by}, {b_ms / row['ms']:.1%}); max|err| {err:.2e}; faults "
            f"rejected at x limit: {fault_text(faults)}")
        rows.append(row)
        del dz, want, m
        torch.cuda.empty_cache()
    return rows


def sweep_verdict(torch, name: str, cases: list, errs: list, scale: list
                  ) -> dict:
    """Exit if any case's max |diff| exceeds check_close's limit, TOL_TTM
    x (1 + max |want|) -> the sweep's summary."""
    errs, scale = torch.stack(errs).cpu(), torch.stack(scale).cpu()
    bad = (~(errs <= TOL_TTM * (1.0 + scale))).nonzero().flatten()
    if len(bad):
        raise SystemExit(
            f"{name} sweep: {len(bad)} of {len(cases)} cases disagree with "
            f"the plain version, first {cases[int(bad[0])]}: max |diff| "
            f"{float(errs[bad[0]]):.3e}")
    return {"cases": len(cases), "max_abs_err": float(errs.max()),
            "nonzero_cases": int((scale > 0).sum())}


def band_sweep(torch, gen) -> dict:
    """``banded_ttm`` against its plain version at small shapes that reach
    every instance the launcher builds: w 1-8 (the register window) and 9
    (the loop), each with 4 columns a thread (NF 36) and one (NF 13, and
    NF 12 with the prefix's pointer, then x's, one float off 16-byte
    alignment); T_s 1-12, lead 0 and w - 1, t_offset -7..+9."""
    from repro_torch.kernels.mproduct import ops, ref

    inputs = {}
    for label, nf, skew_p, skew_x in (("NF 36", 36, 0, 0),
                                      ("NF 13", 13, 0, 0),
                                      ("NF 12 (prefix misaligned)", 12, 1, 0),
                                      ("NF 12 (x misaligned)", 12, 0, 1)):
        inputs[label] = tuple(
            torch.randn(12 * nf + skew, generator=gen, device="cuda"
                        )[skew:].view(12, nf) for skew in (skew_p, skew_x))
    cases, errs, scale = [], [], []
    for label, (p_all, x_all) in inputs.items():
        for w in range(1, 10):
            for t_s in range(1, 13):
                for lead in sorted({0, w - 1}):
                    for off in range(-7, 10):
                        p, x = p_all[:lead], x_all[:t_s]
                        want = ref.banded_ttm_ref(p, x, w, off)
                        cases.append((label, w, t_s, lead, off))
                        errs.append((ops.banded_ttm(p, x, w, off) - want
                                     ).abs().max())
                        scale.append(want.abs().max())
    out = sweep_verdict(torch, "banded_ttm", cases, errs, scale)
    log(f"[kernel] banded_ttm sweep: {out['cases']} cases (w 1-9, T_s 1-12, "
        f"lead 0 and w - 1, t_offset -7..+9; {', '.join(inputs)}), max|err| "
        f"{out['max_abs_err']:.2e} (limit {TOL_TTM:.0e} x (1 + max |want|));"
        f" {out['nonzero_cases']} cases with a nonzero result")
    return out


def band_t_sweep(torch, gen) -> dict:
    """``banded_ttm_t`` against its plain version at small shapes that
    reach every instance the launcher builds: w 1-8 (the unrolled window)
    and 9 (the loop), each with 4 columns a thread (NF 36) and one (NF 13,
    and NF 12 with dZ one float off 16-byte alignment); T_s 1-12, lead 0
    and w - 1, t_offset -7..+9, with and without the prefix's rows."""
    from repro_torch.kernels.mproduct import ops, ref

    inputs = {}
    for nf, skew in ((36, 0), (13, 0), (12, 1)):
        base = torch.randn(12 * nf + skew, generator=gen, device="cuda")
        inputs[f"NF {nf}" + (" misaligned" if skew else "")] = \
            base[skew:].view(12, nf)
    cases, errs, scale = [], [], []
    for label, dz_all in inputs.items():
        for w in range(1, 10):
            for t_s in range(1, 13):
                dz = dz_all[:t_s]
                for lead in sorted({0, w - 1}):
                    for off in range(-7, 10):
                        for wl in (True, False):
                            got = ops.banded_ttm_t(dz, w, off, lead, wl)
                            want = ref.banded_ttm_t_ref(dz, w, off, lead,
                                                        wl)
                            cases.append((label, w, t_s, lead, off, wl))
                            errs.append((got - want).abs().max())
                            scale.append(want.abs().max())
    out = sweep_verdict(torch, "banded_ttm_t", cases, errs, scale)
    log(f"[kernel] banded_ttm_t sweep: {out['cases']} cases (w 1-9, T_s "
        f"1-12, lead 0 and w - 1, t_offset -7..+9, with and without the "
        f"prefix's rows; {', '.join(inputs)}), max|err| "
        f"{out['max_abs_err']:.2e} (limit {TOL_TTM:.0e} x (1 + max "
        f"|want|)); {out['nonzero_cases']} cases with a nonzero result")
    return out


def train_parity(torch):
    """One training step's loss and gradients, card (kernels) against CPU
    (plain versions), from the same parameters, for all three models at
    N = 65,536, T = 16, nb 4, at the full config's widths."""
    import copy

    from repro_torch.configs import registry
    from repro_torch.core import checkpoint as ckpt
    from repro_torch.core import models as tm
    from repro_torch.core.dtdg import build_batch
    from repro_torch.data.dyngnn import synthetic_dataset

    out = {}
    for model, smooth in (("tmgcn", "mproduct"), ("cdgcn", "none"),
                          ("evolvegcn", "edgelife")):
        cfg = dataclasses.replace(registry.get_arch(model).make_config(),
                                  num_nodes=PARITY_N, num_steps=PARITY_T,
                                  checkpoint_blocks=TRAIN_NB)
        ds = synthetic_dataset(PARITY_N, PARITY_T, density=TRAIN_DENSITY,
                               smoothing_mode=smooth, window=cfg.window,
                               seed=1)
        params = tm.init_params(torch.Generator().manual_seed(7), cfg)
        names = [k for k, _ in params.named_parameters()]
        res = {}
        for dev in ("cuda", "cpu"):
            b = build_batch(ds.snapshots, ds.frames, PARITY_N,
                            values=ds.values, device=dev)
            p = copy.deepcopy(params).to(dev)
            loss = ckpt.blocked_node_loss(
                cfg, p, b, torch.from_numpy(ds.labels).to(dev))
            grads = torch.autograd.grad(loss, list(p.parameters()))
            res[dev] = (loss.item(), [g.cpu() for g in grads])
        (lg, gg), (lc, gc) = res["cuda"], res["cpu"]
        worst = abs(lg - lc) / (TOL_GRAD * abs(lc))
        for name, a, b in zip(names, gg, gc, strict=True):
            ratio = float((a - b).abs().max()) / (
                TOL_GRAD * max(float(b.abs().max()), 1e-30))
            if not ratio <= 1.0:
                raise SystemExit(f"train parity {model}: gradient {name} "
                                 f"card vs CPU at {ratio:.3f} x its limit")
            worst = max(worst, ratio)
        if not worst <= 1.0:
            raise SystemExit(f"train parity {model}: loss {lg} vs {lc}")
        out[model] = {"loss_cuda": lg, "loss_cpu": lc,
                      "worst_over_limit": worst}
        log(f"[parity-train] {model} N={PARITY_N} T={PARITY_T} nb "
            f"{TRAIN_NB}: loss card {lg:.7f} / CPU {lc:.7f}; loss and "
            f"{len(names)} gradients within {worst:.3f} of their limits "
            f"({TOL_GRAD} x each leaf's max |value|)")
    return out


# ----------------------------------------------------------- streaming -----

def phase_ms(spans, name: str) -> list[float]:
    return [sp.dur_s * 1e3 for sp in spans if sp.name == name]


def stream_fit(torch, kernels, obs, pipe, overlap: bool, trace: str):
    """One epoch of ``Engine(mode="streamed", device="cuda")`` over the
    pipeline's trace, with ``trace`` "fenced" spans, "host"-clock spans or
    "none", every count zeroed just before the fit and read just after ->
    {result, launches (with the CSR builds), wall_s, spans, peak and
    base bytes (allocated before the fit)}."""
    from repro_torch.configs import registry
    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops
    from repro_torch.run import Engine, ExecutionPlan, InMemoryDTDG, \
        RunConfig

    eng = Engine(RunConfig(
        model=registry.get_arch("paper_dyngnn").make_config(),
        data=InMemoryDTDG(pipe.ds, pipeline=pipe),
        plan=ExecutionPlan(mode="streamed", num_epochs=1, overlap=overlap),
        log_every=8, log_fn=log), device="cuda")
    eng.resolve()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tracer = obs.configure(enabled=trace != "none", fence=trace == "fenced")
    reset_counts(kernels)
    spmm_ops.csr_builds = 0
    t0 = time.perf_counter()
    res = eng.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    launches["csr_builds"] = spmm_ops.csr_builds
    obs.configure(enabled=False)
    return {"result": res, "launches": launches, "wall_s": wall,
            "spans": tracer.spans(), "base": base,
            "peak": torch.cuda.max_memory_allocated()}


def check_stream_counts(path: str, launches: dict, steps: int, k: int,
                        layers: int) -> None:
    """Per step over a slice of k snapshots, TM-GCN with L layers: L k
    aggregates forward and (L - 1) k backward (the frames need no
    gradient), L bands and L transposed bands (slice rows only: the
    detached prefix carry needs no gradient), 2 k CSR builds."""
    check_launches(path, launches, {
        "segment_spmm": steps * (2 * layers - 1) * k,
        "banded_ttm": steps * layers, "banded_ttm_t": steps * layers,
        "flash_decode": 0})
    if launches["csr_builds"] != steps * 2 * k:
        raise SystemExit(f"{path}: {launches['csr_builds']} CSR builds, "
                         f"expected {steps * 2 * k}")


def stream_path(torch, kernels, obs, ds):
    """The streamed schedule: ``paper_dyngnn`` (TM-GCN) at the full
    config's widths over the train phase's trace (N = 755,200, T = 32):
    four per-snapshot epochs through ``Engine(mode="streamed",
    device="cuda")`` in turns, with the prefetch thread (host-clock
    spans), without it (fenced spans: the per-snapshot breakdown), then
    without and with it untraced; then one epoch of
    ``train_streamed(slice_len=8)``.  Launches and CSR builds are counted
    in each; the four per-snapshot runs' losses and parameters are held
    bit-identical -> (the phase's numbers, the pipeline)."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.data.dyngnn import DTDGPipeline
    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops
    from repro_torch.stream import train_loop as st

    cfg = dataclasses.replace(
        registry.get_arch("paper_dyngnn").make_config(),
        num_nodes=ds.num_nodes, num_steps=ds.num_steps)
    t0 = time.perf_counter()
    pipe = DTDGPipeline(ds, nb=cfg.checkpoint_blocks, device="cuda")
    setup_s = time.perf_counter() - t0
    t, layers = ds.num_steps, cfg.num_layers
    rep = pipe.transfer_bytes()
    log(f"[stream] trace N={ds.num_nodes} T={t} (the train phase's), "
        f"block {pipe.bsize}, max_edges {pipe.max_edges}, pads "
        f"{pipe.stream_stats.max_drops}/{pipe.stream_stats.max_adds}; "
        f"pipeline (stats + one encode pass) {setup_s:.1f} s on the host; "
        f"payload {rep['graph_diff']:,} B against naive {rep['naive']:,} B "
        f"(ratio {rep['ratio']:.3f}, {rep['graph_diff'] / t / 1e6:.2f} MB "
        f"a snapshot)")

    # in turns: on (host-clock spans), off (fenced spans: the breakdown),
    # then off and on again untraced
    runs = [stream_fit(torch, kernels, obs, pipe, overlap, trace)
            for overlap, trace in ((True, "host"), (False, "fenced"),
                                   (False, "none"), (True, "none"))]
    for r, overlap in zip(runs, (True, False, False, True), strict=True):
        check_stream_counts("stream" if overlap else "stream (no overlap)",
                            r["launches"], t, 1, layers)
    on, off = runs[0], runs[1]
    losses = on["result"].losses
    if len(losses) != t or not np.isfinite(losses).all():
        raise SystemExit(f"stream: bad losses {losses}")
    for r in runs[1:]:
        if r["result"].losses != losses or not all(
                torch.equal(a, b) for a, b in zip(
                    on["result"].state.params.parameters(),
                    r["result"].state.params.parameters(), strict=True)):
            raise SystemExit("stream: overlap on and off disagree: "
                             f"{losses} vs {r['result'].losses}")
    log("[stream] losses (overlap on == off, bit for bit, and the "
        "parameters, in all four runs): "
        + ", ".join(f"{v:.5f}" for v in losses))
    on_spans, off_spans = on["spans"], off["spans"]
    on_walls = [runs[0]["wall_s"], runs[3]["wall_s"]]
    off_walls = [runs[1]["wall_s"], runs[2]["wall_s"]]
    on_s, off_s = min(on_walls), min(off_walls)

    phases = {name: phase_ms(off_spans, f"stream.{name}")
              for name in ("encode", "stage", "apply", "csr_pair", "step")}
    for name, v in phases.items():
        if len(v) != t:
            raise SystemExit(f"stream: {len(v)} stream.{name} spans, "
                             f"expected {t}")
    phases["step_less_csr"] = [a - b for a, b in zip(
        phases["step"], phases["csr_pair"], strict=True)]
    med = {k: statistics.median(v) for k, v in phases.items()}
    wait = phase_ms(on_spans, "prefetch.wait")
    enc_on = phase_ms(on_spans, "stream.encode")
    stage_on = phase_ms(on_spans, "prefetch.stage")
    on_ms, off_ms = on_s * 1e3 / t, off_s * 1e3 / t
    device_ms = med["stage"] + med["apply"] + med["step"]
    log("[stream] per snapshot without the prefetch thread (fenced spans, "
        "median / max ms): " + ", ".join(
            f"{k} {med[k]:.2f} / {max(phases[k]):.2f}"
            for k in ("encode", "stage", "apply", "csr_pair",
                      "step_less_csr", "step")))
    log(f"[stream] with the prefetch thread (host-clock spans): "
        f"prefetch.wait median {statistics.median(wait):.2f} ms, total "
        f"{sum(wait) / 1e3:.2f} s of {on['wall_s']:.2f} s; worker encode "
        f"median "
        f"{statistics.median(enc_on):.2f} ms, stage (pin + enqueue) median "
        f"{statistics.median(stage_on):.2f} ms")
    bound = "encoder" if med["encode"] > device_ms else "device"
    verdict = (
        f"the host encoder bounds the schedule: {med['encode']:.1f} ms a "
        f"snapshot against {device_ms:.1f} ms of stage + apply + step, so "
        "the prefetch thread can hide at most "
        f"{device_ms / (med['encode'] + device_ms):.1%} of a snapshot"
        if bound == "encoder" else
        f"the prefetch thread can hide the host encoder "
        f"({med['encode']:.1f} ms a snapshot) behind stage + apply + step "
        f"({device_ms:.1f} ms)")
    walls = ", ".join(f"{r['wall_s']:.2f}" for r in runs)
    log(f"[stream] epoch wall, in turns (on traced, off fenced, off, on):"
        f" {walls} s; the faster of each: overlap on {on_ms:.1f} ms a "
        f"snapshot, off {off_ms:.1f} ms; {verdict}")
    log(f"[stream] peak device memory {on['peak'] / 1e9:.3f} GB with the "
        f"prefetch thread, {off['peak'] / 1e9:.3f} GB without; above what "
        f"was allocated before each fit, {(on['peak'] - on['base']) / 1e9:.3f}"
        f" and {(off['peak'] - off['base']) / 1e9:.3f} GB (the eager train "
        "step: 5.266 GB, PERF.md)")

    reset_counts(kernels)
    spmm_ops.csr_builds = 0
    tracer = obs.configure(enabled=True)
    t0 = time.perf_counter()
    sl = st.train_streamed(
        cfg, ds.snapshots, ds.values, ds.frames, ds.labels,
        block_size=pipe.bsize, stats=pipe.stream_stats,
        max_edges=pipe.max_edges, slice_len=STREAM_SLICE, device="cuda")
    torch.cuda.synchronize()
    sl_s = time.perf_counter() - t0
    sl_launches = {k.name: k.launches for k in kernels}
    sl_launches["csr_builds"] = spmm_ops.csr_builds
    obs.configure(enabled=False)
    rounds = t // STREAM_SLICE
    check_stream_counts("stream (slice 8)", sl_launches, rounds,
                        STREAM_SLICE, layers)
    if len(sl.losses) != rounds or not np.isfinite(sl.losses).all():
        raise SystemExit(f"stream slice: bad losses {sl.losses}")
    sl_spans = tracer.spans()
    sl_med = {name: statistics.median(phase_ms(sl_spans, f"stream.{name}"))
              for name in ("encode", "apply", "csr_pair", "step")}
    log(f"[stream] slice_len {STREAM_SLICE}: {rounds} steps in {sl_s:.2f} "
        "s, losses " + ", ".join(f"{v:.5f}" for v in sl.losses)
        + "; per step (fenced, median ms): " + ", ".join(
            f"{k} {v:.2f}" for k, v in sl_med.items())
        + " (encode: per snapshot)")
    return {"T": t, "N": ds.num_nodes, "max_edges": pipe.max_edges,
            "block": pipe.bsize, "pipeline_s": setup_s, "transfer": rep,
            "losses": losses, "launches": on["launches"],
            "overlap_on": {"wall_s": on_walls, "ms_per_snapshot": on_ms,
                           "peak_bytes": on["peak"],
                           "base_bytes": on["base"],
                           "wait_ms_median": statistics.median(wait),
                           "wait_s_total": sum(wait) / 1e3,
                           "encode_ms_median": statistics.median(enc_on),
                           "stage_ms_median": statistics.median(stage_on)},
            "overlap_off": {"wall_s": off_walls, "ms_per_snapshot": off_ms,
                            "peak_bytes": off["peak"],
                            "base_bytes": off["base"], "phases_ms": med},
            "bound_by": bound, "verdict": verdict,
            "slice": {"slice_len": STREAM_SLICE, "wall_s": sl_s,
                      "losses": sl.losses, "launches": sl_launches,
                      "phases_ms": sl_med}}, pipe


def stream_kernel_checks(torch, pipe, window: int, timer) -> dict:
    """The kernels at the streamed step's shapes: ``banded_ttm_t`` on one
    kept row's gradient, (1, lead 4), slice rows only (held to its plain
    version, shown to reject zeros and a dropped row, timed beside its
    bound, plain version and cuBLAS's dense Mᵀ·dZ), and one snapshot's
    CSR-pair build — the step makes one a snapshot, eager training 2 T
    per run — timed against the F = 6 ``segment_spmm`` on its CSR."""
    import numpy as np

    from repro_torch.kernels.segment_spmm import ops
    from repro_torch.stream import train_loop as st

    n = pipe.ds.num_nodes
    gen = torch.Generator(device="cuda").manual_seed(8)
    # global step 16 of the trace: its prefix rows are steps 12-15
    band_t = band_t_rows(torch, gen, n, window, timer,
                         ((1, window - 1, 16 - (window - 1), False),))[0]
    snap, vals = pipe.ds.snapshots[-1], pipe.ds.values[-1]
    e = np.zeros((pipe.max_edges, 2), np.int32)
    m = np.zeros((pipe.max_edges,), np.float32)
    v = np.zeros((pipe.max_edges,), np.float32)
    e[:len(snap)], m[:len(snap)], v[:len(snap)] = snap, 1.0, vals
    e_full, w_full = st.slice_weights_with_loops(
        n, *st.make_self_loops(n, "cuda"),
        *(torch.from_numpy(a)[None].cuda() for a in (e, m, v)))
    e_full, w_full = e_full[0], w_full[0]
    csr = ops.build_csr(e_full, w_full, n)
    x = torch.randn((n, 6), generator=gen, device="cuda")
    times = timer.turns({
        "pair": lambda: ops.build_csr_pair(e_full, w_full, n),
        "spmm": lambda: ops.segment_spmm_csr(x, *csr)})
    lanes = int(e_full.shape[0])
    # the edges and weights read once, two CSRs (row_ptr, col, w) written
    b_ms, b_by = bound_ms(12 * lanes + 2 * (4 * (n + 1) + 8 * lanes), 0.0)
    out = {"lanes": lanes, "nnz": int(csr[0][-1]),
           "pair_ms": times["pair"], "spmm_f6_ms": times["spmm"],
           "ratio": times["pair"] / times["spmm"], "bound_ms": b_ms,
           "bound_by": b_by}
    log(f"[kernel] CSR pair build (forward + transposed, {out['lanes']} "
        f"lanes, {out['nnz']} edges): {out['pair_ms']:.4f} ms a snapshot, "
        f"{out['ratio']:.1f}x the F = 6 segment_spmm on its CSR "
        f"({out['spmm_f6_ms']:.4f} ms); bound {b_ms:.4f} ms ({b_by}, "
        f"{b_ms / out['pair_ms']:.1%})")
    return {"banded_ttm_t": band_t, "csr_pair": out}


def stream_parity(torch):
    """The streamed loss stream, card (kernels, prefetch thread) against
    CPU (plain versions, inline), from the same parameters, for all three
    models at N = 65,536, T = 8 at the full config's widths: each step's
    loss within 1e-4 relative, and the first step's loss and gradients
    within 1e-4 x each leaf's max |value|."""
    import copy

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.core import models as tm
    from repro_torch.data.dyngnn import synthetic_dataset
    from repro_torch.stream import encoder as enc
    from repro_torch.stream import train_loop as st
    from repro_torch.stream.prefetch import DeltaApplier, stage_item

    out = {}
    n, t = STREAM_PARITY_N, STREAM_PARITY_T
    for model, smooth in (("tmgcn", "mproduct"), ("cdgcn", "none"),
                          ("evolvegcn", "edgelife")):
        cfg = dataclasses.replace(registry.get_arch(model).make_config(),
                                  num_nodes=n, num_steps=t,
                                  checkpoint_blocks=TRAIN_NB)
        ds = synthetic_dataset(n, t, density=TRAIN_DENSITY,
                               smoothing_mode=smooth, window=cfg.window,
                               seed=1)
        params = tm.init_params(torch.Generator().manual_seed(7), cfg)
        max_edges = enc.padded_max_edges(ds.snapshots)
        first = next(st.host_stream(ds.snapshots, ds.values, ds.frames,
                                    ds.labels, n, max_edges, t // TRAIN_NB))
        names = [k for k, _ in params.named_parameters()]
        res = {}
        for dev in ("cuda", "cpu"):
            p = copy.deepcopy(params).to(dev)
            item, frame, lab = stage_item(first, dev)
            e, m, v = DeltaApplier(max_edges, dev).consume(item)
            loss, grads, _ = st.slice_value_and_grad(
                cfg, p, st.fresh_carries(cfg, p), frame[None], e[None],
                m[None], v[None], lab[None], 0)
            run = st.train_streamed(
                cfg, ds.snapshots, ds.values, ds.frames, ds.labels,
                params=copy.deepcopy(params), overlap=dev == "cuda",
                device=dev)
            res[dev] = (loss.item(), [g.cpu() for g in grads], run.losses)
        (lg, gg, sg), (lc, gc, sc) = res["cuda"], res["cpu"]
        worst = abs(lg - lc) / (TOL_GRAD * abs(lc))
        for name, a, b in zip(names, gg, gc, strict=True):
            ratio = float((a - b).abs().max()) / (
                TOL_GRAD * max(float(b.abs().max()), 1e-30))
            if not ratio <= 1.0:
                raise SystemExit(f"stream parity {model}: gradient {name} "
                                 f"card vs CPU at {ratio:.3f} x its limit")
            worst = max(worst, ratio)
        steps = [abs(a - b) / (TOL_GRAD * abs(b))
                 for a, b in zip(sg, sc, strict=True)]
        if not (worst <= 1.0 and len(sg) == t and max(steps) <= 1.0
                and np.isfinite(sg).all()):
            raise SystemExit(f"stream parity {model}: losses {sg} vs {sc}, "
                             f"first step {lg} vs {lc}")
        out[model] = {"losses_cuda": sg, "losses_cpu": sc,
                      "loss_worst_over_limit": max(steps),
                      "first_step_worst_over_limit": worst}
        log(f"[parity-stream] {model} N={n} T={t}: {t} losses card vs CPU "
            f"within {max(steps):.3f} of 1e-4 relative (last {sg[-1]:.6f} "
            f"/ {sc[-1]:.6f}); first step's loss and {len(names)} "
            f"gradients within {worst:.3f} of their limits")
    return out


# ------------------------------------------------------- partitioning ------

def nccl_group(torch):
    """A one-rank NCCL process group on cuda:0 (an in-memory store: it
    opens no port)."""
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            device_id=torch.device("cuda", 0))
    return dist.group.WORLD


def partition_path(torch, kernels, obs, ds, pipe, group, eager: dict,
                   timer):
    """The snapshot-partitioned step at P = 1 over a one-rank NCCL group:
    ``paper_dyngnn`` at the full config's widths on the train phase's trace
    (N = 755,200, T = 32, nb 4) through ``Engine(plan=ExecutionPlan(
    mode="eager", mesh=group), device="cuda")``, 10 steps from the same
    seed and optimizer as the train phase; every count zeroed just before
    the fit and read just after (the train phase's 160 / 12 / 8 / 0 a step
    and 2 T CSR builds, the CPU test's counts at P = 1; 40 all-to-alls a
    step, every payload one layer's (8, N, 6) f32, none of it leaving the
    rank), the loss stream held to the train phase's at rtol 1e-5; then
    the warm step (and the cudaMalloc calls it makes), one profiled step
    (NCCL's all-to-all ranges apart from the copies they span), the
    one-rank all-to-all timed on one layer's payload and on the payload a
    P = 4 rank sends, each beside its copy bound and ``clone()``, and its
    host enqueue time -> the path's numbers."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.dist.sharding import ShardLayout, t_to_n
    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops
    from repro_torch.run import Engine, ExecutionPlan, InMemoryDTDG, RunConfig

    cfg = registry.get_arch("paper_dyngnn").make_config()
    t0 = time.perf_counter()
    eng = Engine(RunConfig(model=cfg, data=InMemoryDTDG(ds, pipeline=pipe),
                           plan=ExecutionPlan(mode="eager", mesh=group,
                                              num_steps=TRAIN_STEPS),
                           log_fn=log), device="cuda")
    rr = eng.resolve()
    setup_s = time.perf_counter() - t0
    pipe, nb, n = rr.pipeline, rr.cfg.checkpoint_blocks, rr.cfg.num_nodes
    layers, t = cfg.num_layers, ds.num_steps
    log(f"[partition] P = 1 over NCCL ({torch.cuda.get_device_name(0)}): "
        f"N={n}, T={t}, nb {nb}; plan resolved in {setup_s:.1f} s")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tracer = obs.configure(enabled=True)     # fenced train.step spans
    reset_counts(kernels)
    spmm_ops.csr_builds = 0
    t0 = time.perf_counter()
    res = eng.fit()
    fit_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    builds = spmm_ops.csr_builds
    obs.configure(enabled=False)
    peak = torch.cuda.max_memory_allocated()
    check_launches("partition", launches, train_launches(layers, t, nb))
    if builds != 2 * t:
        raise SystemExit(f"partition: {builds} CSR builds, expected {2 * t}")
    launches["csr_builds"] = builds
    counters = res.metrics["counters"]
    calls = counters.get("partition.a2a_calls", 0)
    handed = counters.get("partition.a2a_bytes", 0)
    remote = counters.get("partition.a2a_remote_bytes", 0)
    payload = (t // nb) * n * 6 * 4
    # per block: the forward's 2 L, the recompute's 2 L - 2 (it stops at
    # the last layer's relu), the backward's 2 L
    want_calls = TRAIN_STEPS * nb * (6 * layers - 2)
    if calls != want_calls or handed != calls * payload or remote != 0:
        raise SystemExit(f"partition: {calls} all-to-alls of {handed} B "
                         f"({remote} B remote), expected {want_calls} of "
                         f"{payload} B each, none remote")
    losses = res.losses
    worst = max(abs(a - b) / abs(b)
                for a, b in zip(losses, eager["losses"], strict=True))
    if not (np.isfinite(losses).all() and worst <= 1e-5):
        raise SystemExit(f"partition: losses {losses} against eager's "
                         f"{eager['losses']} (worst relative {worst:.2e})")
    spans = tracer.spans()
    step_ms = phase_ms(spans, "train.step")
    build_ms = phase_ms(spans, "train.csr_build")
    log("[partition] losses: " + ", ".join(f"{v:.5f}" for v in losses)
        + f"; against the train phase's eager run: worst relative "
        f"{worst:.2e} (limit 1e-5)")
    log(f"[partition] a step: {calls // TRAIN_STEPS} all-to-alls, "
        f"{handed // TRAIN_STEPS:,} B handed to NCCL, {remote} B remote; "
        f"fit {fit_s:.2f} s; train.step (fenced spans) median "
        f"{statistics.median(step_ms):.1f} ms, after the first "
        f"{statistics.median(step_ms[1:]):.1f} (eager "
        f"{eager['step_ms_median_after_first']:.1f}); the rank's 2 T CSR "
        f"builds before the first step {build_ms[0]:.1f} ms")
    log(f"[partition] peak device memory {peak / 1e9:.3f} GB, "
        f"{(peak - base) / 1e9:.3f} above the {base / 1e9:.3f} GB allocated "
        f"before the fit (eager: {eager['peak_bytes'] / 1e9:.3f} GB)")

    step_fn = rr.cache["eager_step"]
    layout = ShardLayout.of(group, nb, t // nb, n)
    args = pipe.rank_arrays(layout)
    csrs = pipe.rank_batch(layout).csr_pairs()
    state = {"params": res.state.params, "opt": res.state.opt_state}

    def one_step():
        state["params"], state["opt"], _ = step_fn(
            state["params"], state["opt"], *args, csrs=csrs)

    mallocs = torch.cuda.memory_stats()["num_device_alloc"]
    steady = alternating_walls(torch, {"step": one_step}, 7)["step"]
    mallocs = torch.cuda.memory_stats()["num_device_alloc"] - mallocs
    ranges: dict = {}
    host_top: list = []
    wall_us, busy, by_name = device_profile(torch, one_step, ranges,
                                            host_top)
    kinds = by_kind(by_name)
    nccl = [us for name, v in ranges.items() if name.startswith("nccl")
            for us in v]
    dtod = by_name.get("Memcpy DtoD (Device -> Device)", [])
    prof = {"steady_ms": steady, "wall_ms": wall_us / 1e3,
            "busy_ms": busy / 1e3, "idle_share": 1 - busy / wall_us,
            "by_kind": kinds, "host_top": host_top,
            "nccl_ranges": len(nccl),
            "nccl_ms": sum(nccl) / 1e3, "dtod_copies": len(dtod),
            "dtod_ms": sum(dtod) / 1e3, "warm_step_device_mallocs": mallocs}
    ep = eager["profile"]
    log(f"[profile-partition] warm step (host clock + sync, median of 6): "
        f"{steady:.1f} ms (eager, this call: {ep['steady_ms']:.1f}); one "
        f"profiled step: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms (eager {ep['busy_ms']:.1f}), idle share "
        f"{1 - busy / wall_us:.3f}")
    log(f"[profile-partition] NCCL's all-to-all ranges: {len(nccl)}, "
        f"{sum(nccl) / 1e3:.3f} ms, spanning its copies (Memcpy DtoD, in "
        f"other copies: {len(dtod)}, {sum(dtod) / 1e3:.3f} ms); cudaMalloc "
        f"calls over the 7 warm steps: {mallocs}")
    log("[profile-partition] host operations by self time, ms (calls), "
        "the eager step's beside:")
    eager_top = {name: (us, c) for name, us, c in ep["host_top"]}
    for name, us, count in host_top:
        e_us, e_c = eager_top.get(name, (0.0, 0))
        log(f"[profile-partition]   {us / 1e3:8.3f} ({count:4d})   eager "
            f"{e_us / 1e3:8.3f} ({e_c:4d})  {name[:70]}")
    log("[profile-partition] device time by kind, ms (launches), eager's "
        "beside:")
    for kind, v in kinds.items():
        e = ep["by_kind"].get(kind, {"ms": 0.0, "count": 0})
        log(f"[profile-partition]   {kind:20s} {v['ms']:8.3f} "
            f"({v['count']:4d})   eager {e['ms']:8.3f} ({e['count']:4d})")
    del args, csrs, state

    a2a = {}
    for label, rows in (("layer payload", t // nb),
                        (f"a P = {PART_P4} rank's payload",
                         t // nb // PART_P4)):
        x = torch.randn((rows, n, 6), device="cuda")
        if not torch.equal(t_to_n(x, group), x):
            raise SystemExit("partition: the one-rank all-to-all changed "
                             "its payload")
        b_ms, b_by = bound_ms(2 * x.nbytes, 0.0)
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)       # the host enqueues ahead
        t0 = time.perf_counter()
        for _ in range(20):
            t_to_n(x, group)
        host_us = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        a2a[label] = {"shape": [rows, n, 6], "bytes": x.nbytes,
                      "host_enqueue_us": host_us,
                      "ms": timer(lambda x=x: t_to_n(x, group)),
                      "wrapper_ms": timer(lambda x=x: t_to_n(x, group),
                                          host=True),
                      "clone_ms": timer(x.clone), "bound_ms": b_ms,
                      "bound_by": b_by}
        r = a2a[label]
        log(f"[partition] one-rank all-to-all, {label} ({rows}, {n}, 6) "
            f"f32, {x.nbytes:,} B: {r['ms']:.4f} ms (with its host call "
            f"{r['wrapper_ms']:.4f}), clone() {r['clone_ms']:.4f}, copy "
            f"bound {b_ms:.4f} ({b_ms / r['ms']:.1%}); the host enqueues "
            f"one in {host_us:.1f} us")
        del x
    torch.cuda.empty_cache()
    return {"N": n, "T": t, "nb": nb, "losses": losses,
            "loss_worst_relative": worst, "launches": launches,
            "a2a": {"calls": calls, "bytes": handed, "remote_bytes": remote,
                    "payload_bytes": payload}, "a2a_timed": a2a,
            "step_ms": step_ms, "csr_build_ms": build_ms,
            "step_ms_median_after_first": statistics.median(step_ms[1:]),
            "fit_s": fit_s, "peak_bytes": peak, "base_bytes": base,
            "profile": prof}


def partition_band_checks(torch, n: int, window: int, timer):
    """The bands at the shapes a P = 4 rank's temporal stage gives them:
    (8, lead 4) x N/4 x 6 = 1,132,800 columns, block 0 (t_offset -4) and
    the later blocks (+4), forward and backward, each held to its plain
    version, shown to reject faults and timed beside its bound, plain
    version and cuBLAS's dense band."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    n_rank = n // PART_P4
    bsize, w1 = TRAIN_T // TRAIN_NB, window - 1
    fwd = band_rows(torch, gen, n_rank, window, timer, (
        (bsize, w1, -w1), (bsize, w1, bsize - w1)))
    bwd = band_t_rows(torch, gen, n_rank, window, timer, (
        (bsize, w1, -w1, False), (bsize, w1, bsize - w1, True)))
    return fwd, bwd


def partition_small(torch, dev: str, group) -> dict:
    """TM-GCN at the full config's widths, N = 65,536, T = 8, nb 2,
    partitioned over ``group`` with this rank's tensors on ``dev``: the
    first step's loss and (all-reduced) gradients, then 4 steps' losses."""
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.core import models as tm
    from repro_torch.core import partition
    from repro_torch.data.dyngnn import DTDGPipeline, synthetic_dataset
    from repro_torch.dist.sharding import ShardLayout
    from repro_torch.optim import adamw
    from repro_torch.train import trainer

    n, t, nb = PART_SHARED_N, PART_SHARED_T, PART_SHARED_NB
    cfg = dataclasses.replace(registry.get_arch("tmgcn").make_config(),
                              num_nodes=n, num_steps=t, checkpoint_blocks=nb)
    ds = synthetic_dataset(n, t, density=TRAIN_DENSITY,
                           smoothing_mode="mproduct", window=cfg.window,
                           seed=1)
    pipe = DTDGPipeline(ds, nb=nb, device=dev)
    layout = ShardLayout.of(group, nb, t // nb, n)
    args = pipe.rank_arrays(layout)
    csrs = pipe.rank_batch(layout).csr_pairs()
    params = tm.init_params(torch.Generator().manual_seed(7), cfg).to(dev)
    names = [k for k, _ in params.named_parameters()]
    share = partition.snapshot_partition_loss(cfg, group)(params, *args,
                                                          csrs=csrs)
    grads = torch.autograd.grad(share, list(params.parameters()))
    for g in grads:
        dist.all_reduce(g, group=group)
    loss = share.detach().clone()
    dist.all_reduce(loss, group=group)
    opt_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2,
                                total_steps=PART_SHARED_STEPS,
                                weight_decay=0.0)
    step = trainer.make_dyngnn_train_step(cfg, group, opt_cfg)
    opt = adamw.init_state(params)
    losses = []
    for _ in range(PART_SHARED_STEPS):
        params, opt, lv = step(params, opt, *args, csrs=csrs)
        losses.append(float(lv))
    return {"loss": float(loss), "losses": losses, "names": names,
            "grads": [g.cpu().numpy() for g in grads]}


def _shared_card_rank(rank: int, src: str, store: str, out_dir: str):
    """One of two ranks sharing cuda:0 over gloo: the small partitioned run
    on the card, then on the CPU, written to ``out_dir``."""
    import datetime
    import pickle

    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        res = {dev: partition_small(torch, dev, dist.group.WORLD)
               for dev in ("cuda", "cpu")}
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, nprocs: int, args: tuple, deadline_s: float) -> None:
    """Spawn ``nprocs`` ranks of ``fn(rank, *args)`` and join them by the
    deadline; a failure, or the deadline, kills the rest and fails."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=max(end - time.monotonic(), 0.0)):
            if time.monotonic() >= end:
                raise SystemExit(f"{nprocs} ranks still running after "
                                 f"{deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def small_close(name: str, got: dict, want: dict) -> float:
    """Losses within 1e-4 relative, first-step loss and gradients within
    1e-4 x each leaf's max |value| -> the worst share of its limit."""
    worst = max(abs(a - b) / (TOL_GRAD * abs(b)) for a, b in zip(
        got["losses"] + [got["loss"]], want["losses"] + [want["loss"]],
        strict=True))
    for k, a, b in zip(want["names"], got["grads"], want["grads"],
                       strict=True):
        ratio = float(abs(a - b).max()) / (
            TOL_GRAD * max(float(abs(b).max()), 1e-30))
        worst = max(worst, ratio)
        if not ratio <= 1.0:
            raise SystemExit(f"{name}: gradient {k} at {ratio:.3f} x its "
                             "limit")
    if not worst <= 1.0:
        raise SystemExit(f"{name}: losses {got['losses']} vs "
                         f"{want['losses']}")
    return worst


def partition_shared_card(torch, group) -> dict:
    """P = 2 ranks sharing the one card over gloo, with CUDA tensors:
    two spawned processes run the small partitioned TM-GCN on cuda:0, then
    on the CPU; held to each other (rank 0 = rank 1), card against CPU and
    against the card's P = 1 run over NCCL."""
    import pickle
    import tempfile

    one = partition_small(torch, "cuda", group)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        run_ranks(_shared_card_rank, 2,
                  (str(SRC), str(Path(d) / "store"), d), RANK_DEADLINE_S)
        ranks_s = time.perf_counter() - t0
        res = []
        for r in range(2):
            with open(Path(d) / f"rank{r}.pkl", "rb") as f:
                res.append(pickle.load(f))
    for dev in ("cuda", "cpu"):
        a, b = res[0][dev], res[1][dev]
        if a["losses"] != b["losses"] or not all(
                (x == y).all() for x, y in zip(a["grads"], b["grads"],
                                               strict=True)):
            raise SystemExit(f"partition shared card: the two ranks "
                             f"disagree on {dev}")
    two = res[0]["cuda"]
    vs_cpu = small_close("P = 2 card vs CPU", two, res[0]["cpu"])
    vs_one = small_close("P = 2 vs P = 1 on the card", two, one)
    log(f"[partition-shared] P = 2 gloo ranks on cuda:0 ({ranks_s:.1f} s "
        f"with their start): losses "
        + ", ".join(f"{v:.6f}" for v in two["losses"])
        + f"; card vs CPU gloo P = 2 within {vs_cpu:.3f} of the limits, vs "
        f"the card's P = 1 within {vs_one:.3f} (loss 1e-4 relative, "
        f"gradients {TOL_GRAD} x each leaf's max)")
    return {"N": PART_SHARED_N, "T": PART_SHARED_T, "losses": two["losses"],
            "losses_cpu": res[0]["cpu"]["losses"], "losses_p1": one["losses"],
            "worst_vs_cpu": vs_cpu, "worst_vs_p1": vs_one,
            "ranks_s": ranks_s}


# ------------------------------------------------- distributed stream ------

def dstream_run(torch, kernels, obs, cfg, ds, pipe, group, stream,
                **kw) -> dict:
    """One ``train_distributed_streamed`` run on the card over ``group``
    from the seed-0 parameters, on the rank's cached ``stream``, every
    count zeroed just before and read just after -> {losses, params,
    launches, counters, wall_s, per_shard_bytes}."""
    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops
    from repro_torch.stream import distributed as sd

    kw.setdefault("num_epochs", DSTREAM_EPOCHS)
    before = dict(obs.metrics_snapshot()["counters"])
    reset_counts(kernels)
    spmm_ops.csr_builds = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = sd.train_distributed_streamed(
        cfg, ds.snapshots, ds.values, ds.frames, ds.labels, mesh=group,
        block_size=pipe.bsize, stats=pipe.stream_stats,
        max_edges=pipe.max_edges, shard_stream=stream, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    launches["csr_builds"] = spmm_ops.csr_builds
    now = dict(obs.metrics_snapshot()["counters"])
    return {"losses": st.losses, "params": st.params, "launches": launches,
            "counters": {k: now.get(k, 0) - before.get(k, 0) for k in now},
            "wall_s": wall, "per_shard_bytes": st.per_shard_bytes}


def same_params(a, b) -> bool:
    return all(x.equal(y) for x, y in zip(a.parameters(), b.parameters(),
                                          strict=True))


def drift(a: list, b: list) -> float:
    return max(abs(x - y) for x, y in zip(a, b, strict=True))


def worst_rel(a: list, b: list) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b, strict=True))


def dstream_path(torch, kernels, obs, ds, pipe, group, timer):
    """The distributed stream at P = 1 over the one-rank NCCL group:
    ``paper_dyngnn`` at the full config's widths on the train phase's trace
    (N = 755,200, T = 32, block 8: 4 rounds an epoch), 2 epochs through
    ``Engine(plan=ExecutionPlan(mode="streamed_mesh", mesh=group),
    device="cuda")``, every count zeroed just before the fit and read just
    after (per round the streamed slice step's 24 / 2 / 2 / 0 launches and
    16 CSR builds, 8 all-to-alls of one layer's (8, N, 6) f32 payload, none
    of it leaving the rank); its loss stream held to the single-device
    ``train_streamed(slice_len=8)`` at rtol 1e-5; then on the rank's cached
    stream: overlap off (identical), ``pipeline_rounds`` and ``a2a_chunks =
    2`` (rtol 1e-5 against the serial run), ``int8_a2a`` and ``int8_all``
    (within DRIFT_ATOL of ``none``; their all-to-all bytes), a fenced run
    (the round's transfer / CSR pair / step medians), ``pipeline_rounds``
    off and on in turns; then one layer's int8 all-to-all, its quantize
    and dequantize passes apart, beside the f32 one and their copy bounds
    -> the path's numbers."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.data.dyngnn import DTDGPipeline
    from repro_torch.dist import compression as comp
    from repro_torch.dist import sharding
    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops
    from repro_torch.run import Engine, ExecutionPlan, InMemoryDTDG, RunConfig
    from repro_torch.stream import train_loop as st

    cfg = registry.get_arch("paper_dyngnn").make_config()
    if pipe is None:
        t0 = time.perf_counter()
        pipe = DTDGPipeline(ds, nb=cfg.checkpoint_blocks, device="cuda")
        log(f"[dstream] pipeline (stats + one encode pass) "
            f"{time.perf_counter() - t0:.1f} s on the host")
    n, t, layers = ds.num_nodes, ds.num_steps, cfg.num_layers
    win = pipe.bsize
    rounds = DSTREAM_EPOCHS * t // win
    cfg = dataclasses.replace(cfg, num_nodes=n, num_steps=t)

    t0 = time.perf_counter()
    ref = st.train_streamed(
        cfg, ds.snapshots, ds.values, ds.frames, ds.labels,
        block_size=win, num_epochs=DSTREAM_EPOCHS, stats=pipe.stream_stats,
        max_edges=pipe.max_edges, slice_len=win, device="cuda")
    ref_s = time.perf_counter() - t0

    eng = Engine(RunConfig(model=cfg, data=InMemoryDTDG(ds, pipeline=pipe),
                           plan=ExecutionPlan(mode="streamed_mesh",
                                              mesh=group,
                                              num_epochs=DSTREAM_EPOCHS),
                           log_every=4, log_fn=log), device="cuda")
    rr = eng.resolve()
    if rr.cfg.checkpoint_blocks != cfg.checkpoint_blocks:
        raise SystemExit("dstream: the plan re-blocked the timeline")
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tracer = obs.configure(enabled=True, fence=False)   # host-clock rounds
    reset_counts(kernels)
    spmm_ops.csr_builds = 0
    t0 = time.perf_counter()
    res = eng.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    launches["csr_builds"] = spmm_ops.csr_builds
    obs.configure(enabled=False)
    peak = torch.cuda.max_memory_allocated()
    check_stream_counts("dstream", launches, rounds, win, layers)
    round_s = sum(sp.dur_s for sp in tracer.spans() if sp.name == "round")
    losses = res.losses
    rel = worst_rel(losses, ref.losses)
    if not (len(losses) == rounds and np.isfinite(losses).all()
            and rel <= 1e-5):
        raise SystemExit(f"dstream: losses {losses} against the slice "
                         f"stream's {ref.losses} (worst relative {rel:.2e})")
    counters = res.metrics["counters"]
    payload = win * n * 6 * 4
    calls = counters.get("partition.a2a_calls", 0)
    handed = counters.get("partition.a2a_bytes", 0)
    remote = counters.get("partition.a2a_remote_bytes", 0)
    want_calls = rounds * 4 * layers          # forward 2 L, backward 2 L
    if (calls != want_calls or handed != calls * payload or remote != 0
            or counters.get("stream.rounds") != rounds):
        raise SystemExit(f"dstream: {calls} all-to-alls of {handed} B "
                         f"({remote} B remote), expected {want_calls} of "
                         f"{payload} B each, none remote")
    per_shard = res.per_shard_bytes
    naive = res.transfer_report["naive"]
    log(f"[dstream] P = 1 over NCCL, N={n} T={t} block {win}: "
        f"{rounds} rounds in {fit_s:.2f} s of fit (the rank's encode "
        f"included; rounds {round_s:.2f} s on the host clock); losses "
        + ", ".join(f"{v:.5f}" for v in losses) + f"; against "
        f"train_streamed(slice_len={win}) on the card ({ref_s:.2f} s): worst "
        f"relative {rel:.2e} (limit 1e-5)")
    log(f"[dstream] a round: {calls // rounds} all-to-alls, "
        f"{handed // rounds:,} B handed to NCCL, {remote} B remote; the "
        f"rank's stream {per_shard[0]:,} B, {per_shard[0] / naive:.3f} of "
        f"naive ({naive:,} B); peak {peak / 1e9:.3f} GB, "
        f"{(peak - base) / 1e9:.3f} above the {base / 1e9:.3f} allocated "
        "before the fit (streamed 0.821, eager 5.266 GB: PERF.md)")

    stream = rr.cache["shard_stream"]
    runs = {"overlap_off": dstream_run(torch, kernels, obs, cfg, ds, pipe,
                                       group, stream, overlap=False),
            "pipelined": dstream_run(torch, kernels, obs, cfg, ds, pipe,
                                     group, stream, pipeline_rounds=True),
            "chunks_2": dstream_run(torch, kernels, obs, cfg, ds, pipe,
                                    group, stream, a2a_chunks=2),
            "int8_a2a": dstream_run(torch, kernels, obs, cfg, ds, pipe,
                                    group, stream, compression="int8_a2a")}
    t0 = time.perf_counter()
    stream8 = pipe.sharded_streams(1, wire="int8", rank=0)[0]
    enc8_s = time.perf_counter() - t0
    runs["int8_all"] = dstream_run(torch, kernels, obs, cfg, ds, pipe, group,
                                   stream8, compression="int8_all")
    for name, r in runs.items():
        check_stream_counts(f"dstream ({name})", r["launches"], rounds, win,
                            layers)
    if runs["overlap_off"]["losses"] != losses or not same_params(
            runs["overlap_off"]["params"], res.state.params):
        raise SystemExit("dstream: overlap on and off disagree")
    for name in ("pipelined", "chunks_2"):
        rel_k = worst_rel(runs[name]["losses"], losses)
        if not rel_k <= 1e-5:
            raise SystemExit(f"dstream: {name} at {rel_k:.2e} of the serial "
                             "run (limit 1e-5)")
    a2a_bytes = {"f32": handed // rounds}
    for name in ("int8_a2a", "int8_all"):
        d = drift(runs[name]["losses"], losses)
        if not d <= DRIFT_ATOL:
            raise SystemExit(f"dstream: {name} drifts {d:.2e} from none "
                             f"(limit {DRIFT_ATOL})")
        c = runs[name]["counters"]
        a2a_bytes[name] = c.get("partition.a2a_bytes", 0) // rounds
        want_q = win * n * 6 * 4 * layers + 4 * 4 * layers
        if (c.get("partition.a2a_calls") != 2 * want_calls
                or a2a_bytes[name] != want_q
                or c.get("partition.a2a_remote_bytes") != 0):
            raise SystemExit(f"dstream: {name} handed {c} to NCCL, "
                             f"expected {2 * want_calls} calls and "
                             f"{want_q} B a round")
    log("[dstream] overlap off: identical; pipeline_rounds "
        f"{worst_rel(runs['pipelined']['losses'], losses):.1e}, "
        f"a2a_chunks 2 {worst_rel(runs['chunks_2']['losses'], losses):.1e} "
        "relative (limit 1e-5); int8_a2a drift "
        f"{drift(runs['int8_a2a']['losses'], losses):.2e}, int8_all "
        f"{drift(runs['int8_all']['losses'], losses):.2e} (limit "
        f"{DRIFT_ATOL}); a round hands NCCL {a2a_bytes['f32']:,} B in f32, "
        f"{a2a_bytes['int8_a2a']:,} B in int8 "
        f"({a2a_bytes['int8_a2a'] / a2a_bytes['f32']:.3f}); the int8 wire "
        f"stream {runs['int8_all']['per_shard_bytes'][0]:,} B against "
        f"{per_shard[0]:,} (encoded in {enc8_s:.1f} s)")

    # the round's phases: fenced spans serialize the schedule
    tracer = obs.configure(enabled=True, fence=True)
    fenced = dstream_run(torch, kernels, obs, cfg, ds, pipe, group, stream,
                         overlap=False)
    spans = tracer.spans()
    obs.configure(enabled=False)
    phases = {k: phase_ms(spans, name) for k, name in (
        ("transfer", "round.transfer"), ("step", "round.step"),
        ("csr_pair", "stream.csr_pair"), ("round", "round"))}
    for k, v in phases.items():
        if len(v) != rounds:
            raise SystemExit(f"dstream: {len(v)} {k} spans, expected "
                             f"{rounds}")
    med = {k: statistics.median(v) for k, v in phases.items()}
    log("[dstream] a round, fenced spans (median / max ms): " + ", ".join(
        f"{k} {med[k]:.2f} / {max(phases[k]):.2f}" for k in phases))
    if fenced["losses"] != losses:
        raise SystemExit("dstream: the fenced run's losses differ")

    walls = {False: [], True: []}
    for _ in range(DSTREAM_PAIRS):
        for pr in (False, True):
            r = dstream_run(torch, kernels, obs, cfg, ds, pipe, group, stream,
                            num_epochs=1, pipeline_rounds=pr)
            walls[pr].append(r["wall_s"] * 1e3 / (t // win))
    off_ms, on_ms = min(walls[False]), min(walls[True])
    log(f"[dstream] a round (host clock over 1-epoch runs in turns, ms): "
        f"pipeline_rounds off {', '.join(f'{v:.1f}' for v in walls[False])}"
        f"; on {', '.join(f'{v:.1f}' for v in walls[True])}; the faster of "
        f"each {off_ms:.1f} / {on_ms:.1f} ({1 - on_ms / off_ms:+.1%} with it)")

    knobs = {"pipelined_rel": worst_rel(runs["pipelined"]["losses"], losses),
             "chunks_2_rel": worst_rel(runs["chunks_2"]["losses"], losses),
             "int8_a2a_drift": drift(runs["int8_a2a"]["losses"], losses),
             "int8_all_drift": drift(runs["int8_all"]["losses"], losses),
             "int8_all_stream_bytes": runs["int8_all"]["per_shard_bytes"]}
    a2a = dstream_a2a_timing(torch, comp, sharding, group, n, win, timer)
    del eng, rr, runs, fenced, stream, stream8
    gc.collect()
    torch.cuda.empty_cache()
    return {"N": n, "T": t, "block": win, "rounds": rounds,
            "losses": losses, "losses_slice_stream": ref.losses,
            "loss_worst_relative": rel, "launches": launches,
            "a2a": {"calls": calls, "bytes": handed, "remote_bytes": remote,
                    "payload_bytes": payload, "per_round_bytes": a2a_bytes},
            "per_shard_bytes": per_shard, "naive_bytes": naive,
            "fit_s": fit_s, "rounds_host_s": round_s, "ref_s": ref_s,
            "int8_wire_encode_s": enc8_s, "peak_bytes": peak,
            "base_bytes": base, "fenced_ms": med,
            "pipeline_rounds_ms": {"off": walls[False], "on": walls[True]},
            "knobs": knobs, "a2a_timed": a2a}


def dstream_a2a_timing(torch, comp, sharding, group, n: int, win: int,
                       timer) -> dict:
    """One layer's payload (win, N, 6) through the one-rank all-to-all:
    f32 (``t_to_n``), and on the int8 wire (``quantized_t_to_n``: the
    residual added, quantize, the int8 and scale all-to-alls, dequantize,
    the new residual), with its quantize pass, its int8 all-to-all and its
    dequantize pass timed apart; each beside its copy bound (bytes read
    once and written once at 3.35 TB/s)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((win, n, 6), generator=gen, device="cuda")
    res = torch.randn((win, n, 6), generator=gen, device="cuda") * 0.01
    pieces = sharding.t2n_send(x + res, 1)
    q, scales = comp.quantize_pieces(pieces)
    back = comp.dequantize_pieces(q, scales)
    if not (torch.equal(comp.quantized_t_to_n(x, res, group)[0],
                        sharding.t2n_recv(back))
            and torch.equal(sharding.all_to_all(q, group), q)):
        raise SystemExit("dstream: the one-rank int8 all-to-all changed its "
                         "payload")
    elems = x.numel()
    fns = {"f32_a2a": (lambda: sharding.t_to_n(x, group), 8 * elems),
           "int8_a2a": (lambda: sharding.all_to_all(q, group), 2 * elems),
           "quantize": (lambda: comp.quantize_pieces(pieces), 5 * elems),
           "dequantize": (lambda: comp.dequantize_pieces(q, scales),
                          5 * elems),
           "quantized_t_to_n": (lambda: comp.quantized_t_to_n(x, res, group),
                                16 * elems)}
    times = timer.turns({k: f for k, (f, _) in fns.items()})
    out = {}
    for k, (f, nbytes) in fns.items():
        b_ms, _ = bound_ms(nbytes, 0.0)
        out[k] = {"ms": times[k], "wrapper_ms": timer(f, host=True),
                  "bytes": nbytes, "bound_ms": b_ms}
        log(f"[dstream] {k} on ({win}, {n}, 6): {times[k]:.4f} ms (with its "
            f"host calls {out[k]['wrapper_ms']:.4f}), copy bound "
            f"{b_ms:.4f} ({b_ms / times[k]:.1%})")
    return out


def dstream_small(torch, dev: str, group, compression: str) -> list:
    """TM-GCN at the full config's widths, N = 65,536, T = 8, block 4,
    the distributed stream over ``group`` with this rank's tensors on
    ``dev``, 2 epochs from the seed-7 parameters -> the loss stream."""
    from repro_torch.configs import registry
    from repro_torch.core import models as tm
    from repro_torch.data.dyngnn import synthetic_dataset
    from repro_torch.stream import distributed as sd

    n, t, nb = DSTREAM_SHARED_N, DSTREAM_SHARED_T, DSTREAM_SHARED_NB
    cfg = dataclasses.replace(registry.get_arch("tmgcn").make_config(),
                              num_nodes=n, num_steps=t, checkpoint_blocks=nb)
    ds = synthetic_dataset(n, t, density=TRAIN_DENSITY,
                           smoothing_mode="mproduct", window=cfg.window,
                           seed=1)
    params = tm.init_params(torch.Generator().manual_seed(7), cfg)
    return sd.train_distributed_streamed(
        cfg, ds.snapshots, ds.values, ds.frames, ds.labels, mesh=group,
        num_epochs=DSTREAM_EPOCHS, params=params, compression=compression,
        pipeline_rounds=True, device=dev).losses


def _dstream_shared_rank(rank: int, src: str, store: str, out_dir: str):
    """One of two ranks sharing cuda:0 over gloo: the small distributed
    stream on the card, then on the CPU, for ``none`` and ``int8_a2a``,
    written to ``out_dir``."""
    import datetime
    import pickle

    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        res = {(comp, dev): dstream_small(torch, dev, dist.group.WORLD,
                                          comp)
               for comp in ("none", "int8_a2a") for dev in ("cuda", "cpu")}
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def dstream_shared_card(torch, group) -> dict:
    """P = 2 ranks sharing the one card over gloo, with CUDA tensors: the
    small distributed stream on cuda:0, then on the CPU, for ``none`` and
    ``int8_a2a``; held to each other (rank 0 = rank 1), card against CPU
    gloo P = 2 (1e-4 relative) and against the card's P = 1 over NCCL
    (``none`` 1e-4 relative; ``int8_a2a`` within DRIFT_ATOL: its pieces,
    and so its scales, differ with P)."""
    import pickle
    import tempfile

    one = {c: dstream_small(torch, "cuda", group, c)
           for c in ("none", "int8_a2a")}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        run_ranks(_dstream_shared_rank, 2,
                  (str(SRC), str(Path(d) / "store"), d), RANK_DEADLINE_S)
        ranks_s = time.perf_counter() - t0
        res = []
        for r in range(2):
            with open(Path(d) / f"rank{r}.pkl", "rb") as f:
                res.append(pickle.load(f))
    out = {"N": DSTREAM_SHARED_N, "T": DSTREAM_SHARED_T, "ranks_s": ranks_s,
           "p1": one}
    for c in ("none", "int8_a2a"):
        card, cpu = res[0][(c, "cuda")], res[0][(c, "cpu")]
        if res[1][(c, "cuda")] != card or res[1][(c, "cpu")] != cpu:
            raise SystemExit(f"dstream shared card: the two ranks disagree "
                             f"({c})")
        vs_cpu = worst_rel(card, cpu)
        vs_one = (worst_rel(card, one[c]) if c == "none"
                  else drift(card, one[c]))
        limit_one = TOL_GRAD if c == "none" else DRIFT_ATOL
        if not (vs_cpu <= TOL_GRAD and vs_one <= limit_one):
            raise SystemExit(f"dstream shared card {c}: {card} vs CPU {cpu} "
                             f"and P = 1 {one[c]}")
        out[c] = {"losses": card, "losses_cpu": cpu, "vs_cpu": vs_cpu,
                  "vs_p1": vs_one}
        log(f"[dstream-shared] {c}: P = 2 gloo ranks on cuda:0, losses "
            + ", ".join(f"{v:.6f}" for v in card)
            + f"; vs CPU gloo P = 2 {vs_cpu:.2e} relative (limit "
            f"{TOL_GRAD}), vs the card's P = 1 {vs_one:.2e} (limit "
            f"{limit_one}{' relative' if c == 'none' else ' absolute'})")
    log(f"[dstream-shared] ranks took {ranks_s:.1f} s with their start")
    return out


# ------------------------------------------------------------- hybrid ------

def hybrid_batch(torch, ds, n: int, pm: int, dev: str):
    """The dataset's padded batch on ``dev`` and its edges split into
    ``pm`` destination shards (``partition_edges_for_hybrid``, on the
    host) -> (batch, edges (T, pm E, 2), weights (T, pm E) on ``dev``)."""
    from repro_torch.core import dtdg, hybrid

    batch = dtdg.build_batch(ds.snapshots, ds.frames, n, values=ds.values,
                             device=dev)
    e_h, w_h = hybrid.partition_edges_for_hybrid(
        batch.edges.cpu().numpy(), batch.edge_weights.cpu().numpy(),
        batch.edge_mask.cpu().numpy(), n, pm=pm,
        max_local_edges=batch.edges.shape[1])
    return (batch, torch.from_numpy(e_h).to(dev),
            torch.from_numpy(w_h).to(dev))


def hybrid_path(torch, kernels, ds, group, timer):
    """The hybrid scheme (§6.5) at full width on a 1 x 1 grid over the
    one-rank NCCL group: ``paper_dyngnn``'s widths on the train phase's
    trace (N = 755,200, T = 32), its edges split into the one destination
    shard, ``core.hybrid.hybrid_forward`` (random seed-0 parameters), every
    count zeroed just before the forward and read just after (L T
    ``segment_spmm``, L ``banded_ttm``, T rectangular CSR builds); Z held
    to ``models.forward`` on the same batch (1e-5: the same CSRs and
    kernels, so 0.0 is expected); the forward timed beside the eager one
    (``forward_slice`` building its T CSRs, as the hybrid forward does);
    then the rectangular kernel at a Pm = 4 rank's shape -> the path's
    numbers."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.core import hybrid
    from repro_torch.core import models as tm
    from repro_torch.dist import sharding
    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops

    n, t = ds.num_nodes, ds.num_steps
    cfg = dataclasses.replace(registry.get_arch("paper_dyngnn").make_config(),
                              num_nodes=n, num_steps=t)
    layers = cfg.num_layers
    t0 = time.perf_counter()
    batch, e_h, w_h = hybrid_batch(torch, ds, n, 1, "cuda")
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    grid = sharding.make_grid(1, 1, group)
    params = tm.init_params(torch.Generator().manual_seed(0), cfg).to("cuda")
    fwd = hybrid.hybrid_forward(cfg, grid)
    frames, edges, ew = hybrid.local_blocks(grid, batch.frames, e_h, w_h)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    spmm_ops.csr_builds = 0
    z = fwd(params, frames, edges, ew)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    launches["csr_builds"] = spmm_ops.csr_builds
    peak = torch.cuda.max_memory_allocated()
    check_launches("hybrid", launches, {
        "segment_spmm": layers * t, "banded_ttm": layers,
        "banded_ttm_t": 0, "flash_decode": 0})
    if launches["csr_builds"] != t:
        raise SystemExit(f"hybrid: {launches['csr_builds']} CSR builds, "
                         f"expected {t}")
    with torch.no_grad():
        want = tm.forward(cfg, params, batch)
    if z.shape != want.shape or not bool(torch.isfinite(z).all()):
        raise SystemExit(f"hybrid: Z {tuple(z.shape)} against "
                         f"{tuple(want.shape)}, or not finite")
    err = check_close("hybrid Z vs models.forward", z, want, TOL_TTM)

    def eager():
        with torch.no_grad():
            return tm.forward_slice(cfg, params, batch.frames, batch.edges,
                                    batch.edge_weights,
                                    tm.init_carries(cfg, params,
                                                    device="cuda"), 0)[0]

    walls = alternating_walls(torch, {
        "hybrid": lambda: fwd(params, frames, edges, ew), "eager": eager},
        rounds=HYBRID_REPS)
    log(f"[hybrid] 1 x 1 grid over NCCL, N={n} T={t}: Z max|err| {err:.2e} "
        f"against models.forward (limit {TOL_TTM} abs + rel); forward "
        f"{walls['hybrid']:.2f} ms against the eager forward's "
        f"{walls['eager']:.2f} (host clock, {HYBRID_REPS - 1} rounds in "
        f"turns, each building its {t} CSRs); peak {peak / 1e9:.3f} GB, "
        f"{(peak - base) / 1e9:.3f} above the batch; batch and shard "
        f"split {prep_s:.1f} s")
    del z, want, frames, edges, ew, e_h, w_h
    gc.collect()
    gather = frame_gather_ms(torch, group, t, n, cfg.hidden, timer)
    log(f"[hybrid] one-rank frame all-gather ({t}, {n}, {cfg.hidden}) "
        f"over NCCL: into one tensor {gather['into_tensor']:.4f} ms, into a "
        f"list of its views {gather['list']:.4f}, one copy of the frame "
        f"{gather['copy']:.4f} (device time, in turns)")
    rect = hybrid_rect_check(torch, batch, n, timer)
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"N": n, "T": t, "launches": launches, "max_abs_err": err,
            "forward_ms": walls, "peak_bytes": peak, "base_bytes": base,
            "prep_s": prep_s, "frame_all_gather_ms": gather,
            "rectangular": rect}


def frame_gather_ms(torch, group, t: int, n: int, f: int, timer) -> dict:
    """The hybrid forward's frame all-gather at its (T, N, F) shape over
    ``group``, two ways: ``all_gather_into_tensor`` into one buffer (what
    ``dist.sharding.all_gather`` issues) and ``all_gather`` into
    a list of that buffer's views (which NCCL gathers into a staging
    buffer and copies out), beside one copy of the frame -> {way: median
    device ms}."""
    import torch.distributed as dist

    x = torch.ones((t, n, f), device="cuda")
    out = x.new_empty((dist.get_world_size(group),) + tuple(x.shape))
    ms = timer.turns({
        "into_tensor": lambda: dist.all_gather_into_tensor(
            out.flatten(0, 1), x, group=group),
        "list": lambda: dist.all_gather(list(out.unbind(0)), x,
                                        group=group),
        "copy": lambda: out[0].copy_(x)})
    del x, out
    return ms


def hybrid_rect_check(torch, batch, n: int, timer) -> list:
    """``segment_spmm`` on a rectangular CSR at a Pm = 4 rank's shape:
    the last snapshot's edges (self-loops and Laplacian weights) whose
    destination is rank 1's (N/4 rows, ids made local), gathered from all
    N source rows; at F = 2 and 6, held to the plain version, shown to
    reject zeros and each row's last edge dropped, timed beside its bound
    (its bytes count each x row the CSR gathers once, and no other), the
    plain version and ``torch.sparse.mm`` on the same (N/4, N) matrix."""
    from repro_torch.kernels.segment_spmm import ops, ref

    n_loc = n // 4
    e, w = batch.edges[-1], batch.edge_weights[-1]
    sel = (e[:, 1] >= n_loc) & (e[:, 1] < 2 * n_loc) & (w != 0)
    e_loc = e[sel].clone()
    e_loc[:, 1] -= n_loc
    w_loc = w[sel].contiguous()
    row_ptr, col, wc = ops.build_csr(e_loc, w_loc, n_loc)
    nnz = int(row_ptr[-1])
    x_rows = int(torch.unique(col[:nnz]).numel())
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for f in (2, 6):
        x = torch.randn((n, f), generator=gen, device="cuda")
        got = ops.segment_spmm_csr(x, row_ptr, col, wc)
        want = ref.segment_spmm_csr_ref(x, row_ptr, col, wc)
        torch.cuda.synchronize()
        if got.shape != (n_loc, f):
            raise SystemExit(f"segment_spmm rectangular: {tuple(got.shape)}"
                             f", expected {(n_loc, f)}")
        err = check_close(f"segment_spmm rectangular F={f}", got, want,
                          TOL_SPMM)
        faults = spmm_faults(f"rectangular F={f}", ops, x, row_ptr, col, wc,
                             want)
        csr = torch.sparse_csr_tensor(row_ptr, col[:nnz], wc[:nnz],
                                      size=(n_loc, n),
                                      check_invariants=False)
        lib_err = float((torch.sparse.mm(csr, x) - want).abs().max())
        # each x row the CSR gathers is read once; the others not at all
        nbytes = (x_rows * f * x.element_size() + row_ptr.nbytes + nnz * 8
                  + got.nbytes)
        b_ms, b_by = bound_ms(nbytes, 2.0 * nnz * f)
        row = {"F": f, "rows": n_loc, "source_rows": n,
               "source_rows_read": x_rows, "nnz": nnz,
               "ms": timer(lambda x=x: ops.segment_spmm_csr(x, row_ptr, col,
                                                            wc)),
               "wrapper_ms": timer(lambda x=x: ops.segment_spmm_csr(
                   x, row_ptr, col, wc), host=True),
               "plain_ms": timer(lambda x=x: ref.segment_spmm_csr_ref(
                   x, row_ptr, col, wc)),
               "library_ms": timer(lambda x=x, csr=csr: torch.sparse.mm(
                   csr, x)),
               "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
               "fault_over_limit": faults, "library_max_abs_err": lib_err}
        log(f"[kernel] segment_spmm rectangular ({n_loc} rows from {n}, "
            f"{x_rows} of them read, {nnz} edges) F={f}: kernel "
            f"{row['ms']:.4f} ms (wrapper {row['wrapper_ms']:.4f}), plain "
            f"{row['plain_ms']:.4f}, torch.sparse.mm "
            f"{row['library_ms']:.4f}, bound {b_ms:.4f} "
            f"({b_by}, {b_ms / row['ms']:.1%}); max|err| {err:.2e}; faults "
            f"rejected at x limit: zeros {faults['zeros']:.1f}, last edge "
            f"dropped {faults['last edge dropped']:.1f}")
        rows.append(row)
    return rows


def hybrid_small(torch, dev: str, grid) -> dict:
    """TM-GCN at the full config's widths, N = 65,536, T = 8, through
    ``hybrid_forward`` on ``grid`` with this rank's tensors on ``dev``,
    from the seed-7 parameters -> {rank's Z block, its grid place}."""
    from repro_torch.configs import registry
    from repro_torch.core import hybrid
    from repro_torch.core import models as tm
    from repro_torch.data.dyngnn import synthetic_dataset

    n, t = HYBRID_SHARED_N, HYBRID_SHARED_T
    cfg = dataclasses.replace(registry.get_arch("tmgcn").make_config(),
                              num_nodes=n, num_steps=t)
    ds = synthetic_dataset(n, t, density=TRAIN_DENSITY,
                           smoothing_mode="mproduct", window=cfg.window,
                           seed=1)
    batch, e_h, w_h = hybrid_batch(torch, ds, n, grid.pm, dev)
    params = tm.init_params(torch.Generator().manual_seed(7), cfg).to(dev)
    blocks = hybrid.local_blocks(grid, batch.frames, e_h, w_h)
    z = hybrid.hybrid_forward(cfg, grid)(params, *blocks)
    out = {"z": z.cpu().numpy(), "place": (grid.data_index,
                                           grid.model_index)}
    if grid.pd * grid.pm == 1:
        with torch.no_grad():
            out["eager"] = tm.forward(cfg, params, batch).cpu().numpy()
    return out


def _hybrid_shared_rank(rank: int, src: str, store: str, out_dir: str):
    """One of four ranks sharing cuda:0 over gloo as a 2 x 2 grid: the
    small hybrid forward on the card, then on the CPU, written to
    ``out_dir``."""
    import datetime
    import pickle

    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist

    from repro_torch.dist import sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=120))
    try:
        grid = sharding.make_grid(2, 2)
        res = {dev: hybrid_small(torch, dev, grid) for dev in ("cuda", "cpu")}
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def hybrid_shared_card(torch, group) -> dict:
    """A 2 x 2 grid of four ranks sharing the one card over gloo, with
    CUDA tensors: the small hybrid forward on cuda:0, then on the CPU;
    the ranks' blocks assembled, card against CPU gloo and against the
    card's 1 x 1 grid over NCCL and its eager forward (1e-4 abs + rel:
    the kernel sums in another order than the plain version)."""
    import pickle
    import tempfile

    import numpy as np

    from repro_torch.dist import sharding

    one = hybrid_small(torch, "cuda", sharding.make_grid(1, 1, group))
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        run_ranks(_hybrid_shared_rank, 4,
                  (str(SRC), str(Path(d) / "store"), d), RANK_DEADLINE_S)
        ranks_s = time.perf_counter() - t0
        res = []
        for r in range(4):
            with open(Path(d) / f"rank{r}.pkl", "rb") as f:
                res.append(pickle.load(f))

    def assemble(dev):
        if [r[dev]["place"] for r in res] != [(0, 0), (0, 1), (1, 0),
                                              (1, 1)]:
            raise SystemExit("hybrid shared card: the ranks' grid places "
                             f"{[r[dev]['place'] for r in res]}")
        return np.concatenate([np.concatenate([res[2 * d + m][dev]["z"]
                                               for m in range(2)], axis=1)
                               for d in range(2)], axis=0)

    card, cpu = assemble("cuda"), assemble("cpu")
    out = {"N": HYBRID_SHARED_N, "T": HYBRID_SHARED_T, "ranks_s": ranks_s}
    for name, want in (("cpu", cpu), ("p1", one["z"]),
                       ("eager", one["eager"])):
        err = float(np.abs(card - want).max())
        limit = TOL_SPMM * (1.0 + float(np.abs(want).max()))
        if not (card.shape == want.shape and err <= limit):
            raise SystemExit(f"hybrid shared card: 2 x 2 on the card vs "
                             f"{name}: max|diff| {err:.3e} > {limit:.3e}")
        out[f"vs_{name}"] = err
    log(f"[hybrid-shared] 2 x 2 gloo ranks on cuda:0 ({ranks_s:.1f} s with "
        f"their start), N={HYBRID_SHARED_N} T={HYBRID_SHARED_T}: Z max|diff| "
        f"vs CPU gloo {out['vs_cpu']:.2e}, vs the card's 1 x 1 over NCCL "
        f"{out['vs_p1']:.2e}, vs its eager forward {out['vs_eager']:.2e} "
        f"(limit {TOL_SPMM} abs + rel)")
    return out


# ------------------------------------------------------------ sampled ------

def sampled_path(torch, kernels, obs, ds, group):
    """The sampled schedule at full width over the one-rank NCCL group:
    ``paper_dyngnn`` on the train phase's trace (N = 755,200, T = 32),
    block 8 (2 epochs of 4 rounds), through ``Engine(plan=
    ExecutionPlan(mode="sampled", mesh=group), device="cuda")`` with the
    launcher's defaults (N / 4 seeds a round, fanouts 10, 10) and the
    union's edges capped at the largest snapshot's; the budget gate set
    between the sampled and the full-graph round: ``streamed_mesh``
    refuses, ``sampled`` trains within it; every count zeroed just before
    the fit and read just after (per round the slice step's 24 / 2 / 2 / 0
    and 16 CSR builds); fenced spans per round (host sampling, staging,
    the carries' gather, all-gather and scatter, the step, its CSR
    pairs) -> the path's numbers."""
    import numpy as np

    from repro_torch import hoststore as hs
    from repro_torch.configs import registry
    from repro_torch.data.dyngnn import DTDGPipeline
    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops
    from repro_torch.run import (Engine, ExecutionPlan, InMemoryDTDG,
                                 RunConfig, SamplingSpec)

    sub, win = ds, SAMPLED_BLOCK
    n, t = sub.num_nodes, sub.num_steps
    cfg = dataclasses.replace(registry.get_arch("paper_dyngnn").make_config(),
                              num_nodes=n, num_steps=t,
                              checkpoint_blocks=t // win)
    layers = cfg.num_layers
    t0 = time.perf_counter()
    pipe = DTDGPipeline(sub, nb=t // win, device="cuda")
    pipe_s = time.perf_counter() - t0
    e_max = max(s.shape[0] for s in sub.snapshots)
    spec = SamplingSpec(batch_nodes=n // 4, fanouts=(10, 10),
                        max_edges=e_max)
    resolved = spec.resolve(n, win, 1)
    sampled_b = hs.sampled_round_bytes(resolved, win=win, num_shards=1,
                                       feat_dim=sub.frames.shape[-1])
    full_b = hs.full_graph_round_bytes(
        "streamed_mesh", num_steps=t, win=win, num_shards=1,
        max_edges=pipe.max_edges, num_nodes=n, feat_dim=sub.frames.shape[-1])
    budget = (sampled_b + full_b) // 2
    if not sampled_b < budget < full_b:
        raise SystemExit(f"sampled: no budget between the sampled round's "
                         f"{sampled_b} B and the full one's {full_b} B")
    data = InMemoryDTDG(sub, pipeline=pipe)
    try:
        Engine(RunConfig(model=cfg, data=data, plan=ExecutionPlan(
            mode="streamed_mesh", mesh=group, device_budget_bytes=budget),
            log_fn=log), device="cuda").fit()
        raise SystemExit("sampled: streamed_mesh trained within a budget "
                         "below its round")
    except hs.DeviceBudgetError as e:
        refusal = str(e)
    eng = Engine(RunConfig(model=cfg, data=data, plan=ExecutionPlan(
        mode="sampled", mesh=group, sampling=spec, num_epochs=SAMPLED_EPOCHS,
        device_budget_bytes=budget), log_every=1, log_fn=log),
        device="cuda")
    rr = eng.resolve()
    t0 = time.perf_counter()
    rr.cache["host_store"] = hs.TemporalCSRStore.from_stream(
        pipe.host_stream(), n)
    store_s = time.perf_counter() - t0
    store_bytes = rr.cache["host_store"].nbytes
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tracer = obs.configure(enabled=True, fence=True)
    reset_counts(kernels)
    spmm_ops.csr_builds = 0
    t0 = time.perf_counter()
    res = eng.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    launches["csr_builds"] = spmm_ops.csr_builds
    spans = tracer.spans()
    obs.configure(enabled=False)
    peak = torch.cuda.max_memory_allocated()
    rounds = SAMPLED_EPOCHS * t // win
    check_stream_counts("sampled", launches, rounds, win, layers)
    rep = res.sample_report
    losses = res.losses
    if not (len(losses) == rounds and np.isfinite(losses).all()
            and rep.rounds == rounds):
        raise SystemExit(f"sampled: losses {losses}, {rep.rounds} rounds")
    if res.budget_report != {"required": sampled_b, "budget": budget}:
        raise SystemExit(f"sampled: budget report {res.budget_report}")
    per_round = {k: phase_ms(spans, name) for k, name in (
        ("sample", "sample.round"), ("stage", "sample.stage"),
        ("carry_gather", "carry.gather"), ("step", "round.step"),
        ("csr_pair", "stream.csr_pair"),
        ("carry_all_gather", "carry.all_gather"),
        ("carry_scatter", "carry.scatter"), ("round", "round"),
        ("prefetch_wait", "prefetch.wait"))}
    for k in ("sample", "stage", "carry_gather", "step", "csr_pair",
              "carry_scatter", "round"):
        if len(per_round[k]) != rounds:
            raise SystemExit(f"sampled: {len(per_round[k])} {k} spans, "
                             f"expected {rounds}")
    staged_round = rep.staged_bytes // rounds
    warm_step = statistics.median(per_round["step"][1:])
    log(f"[sampled] P = 1 over NCCL, N={n} T={t} block {win}, "
        f"{spec.batch_nodes} seeds, fanouts {spec.fanouts}: table_pad "
        f"{resolved.table_pad}, edge_pad {resolved.edge_pad} (the largest "
        f"snapshot's {e_max} edges), table filled up to "
        f"{rep.table_fill_max}; dropped {rep.dropped_nodes} nodes, "
        f"{rep.dropped_edges} edges; {rep.sampled_edges} union edges staged")
    log(f"[sampled] {rounds} rounds in {fit_s:.1f} s of fit (store ingest "
        f"{store_s:.1f} s, {store_bytes / 1e6:.1f} MB on the host, before "
        f"it; pipeline {pipe_s:.1f} s); losses "
        + ", ".join(f"{v:.5f}" for v in losses))
    for k, v in per_round.items():
        log(f"[sampled]   {k}: " + ", ".join(f"{x:.1f}" for x in v) + " ms")
    log(f"[sampled] warm step {warm_step:.1f} ms (the median of rounds 1-"
        f"{rounds - 1}'s round.step)")
    log(f"[sampled] staged {staged_round:,} B a round (the round's graph "
        f"tensors and its table rows of the carries) "
        f"against the full-graph round's {full_b:,} B; sampled_round_bytes "
        f"{sampled_b:,}; budget {budget:,} B: streamed_mesh refused "
        f"({refusal[:60]}...), sampled fit; peak {peak / 1e9:.3f} GB, "
        f"{(peak - base) / 1e9:.3f} above the {base / 1e9:.3f} allocated "
        "before the fit")
    del eng, rr, res, pipe, data
    gc.collect()
    torch.cuda.empty_cache()
    return {"N": n, "T": t, "block": win, "rounds": rounds,
            "seeds": spec.batch_nodes, "fanouts": list(spec.fanouts),
            "table_pad": resolved.table_pad, "edge_pad": resolved.edge_pad,
            "largest_snapshot_edges": e_max,
            "table_fill_max": rep.table_fill_max,
            "dropped_nodes": rep.dropped_nodes,
            "dropped_edges": rep.dropped_edges,
            "sampled_edges": rep.sampled_edges, "losses": losses,
            "launches": launches, "per_round_ms": per_round,
            "warm_step_ms": warm_step,
            "staged_bytes_per_round": staged_round,
            "sampled_round_bytes": sampled_b, "full_round_bytes": full_b,
            "budget": budget, "peak_bytes": peak, "base_bytes": base,
            "fit_s": fit_s, "store_s": store_s, "store_bytes": store_bytes,
            "pipeline_s": pipe_s}


def sampled_small(torch, dev: str, group, full: bool) -> dict:
    """TM-GCN at the full config's widths, N = 65,536, T = 8, block 4, 2
    epochs over ``group`` with this rank's tensors on ``dev`` from the
    seed-7 parameters: ``train_sampled`` with every vertex a seed and full
    fanout (``full``; then also the distributed stream, its full-graph
    counterpart) or with N / 4 seeds and fanouts 10, 10; the union's edges
    capped at the largest snapshot's -> the loss streams."""
    from repro_torch import hoststore as hs
    from repro_torch.configs import registry
    from repro_torch.core import models as tm
    from repro_torch.data.dyngnn import DTDGPipeline, synthetic_dataset
    from repro_torch.stream import distributed as sd

    n, t, win = SAMPLED_SMALL_N, SAMPLED_SMALL_T, SAMPLED_SMALL_BLOCK
    cfg = dataclasses.replace(registry.get_arch("tmgcn").make_config(),
                              num_nodes=n, num_steps=t,
                              checkpoint_blocks=t // win)
    ds = synthetic_dataset(n, t, density=TRAIN_DENSITY,
                           smoothing_mode="mproduct", window=cfg.window,
                           seed=1)
    pipe = DTDGPipeline(ds, nb=t // win, device=dev)
    store = hs.TemporalCSRStore.from_stream(pipe.host_stream(), n)
    e_max = max(s.shape[0] for s in ds.snapshots)
    deg = store.max_in_degree()
    spec = (hs.SamplingSpec(batch_nodes=n, fanouts=(deg, deg),
                            max_edges=e_max) if full
            else hs.SamplingSpec(batch_nodes=n // 4, fanouts=(10, 10),
                                 max_edges=e_max))

    def params():
        return tm.init_params(torch.Generator().manual_seed(7), cfg)

    st = hs.train_sampled(cfg, store, ds.frames, ds.labels, spec=spec,
                          mesh=group, block_size=win,
                          num_epochs=SAMPLED_SMALL_EPOCHS, params=params(),
                          device=dev)
    out = {"losses": st.losses, "dropped": (st.report.dropped_nodes,
                                            st.report.dropped_edges),
           "max_in_degree": deg}
    if full:
        out["streamed_mesh"] = sd.train_distributed_streamed(
            cfg, ds.snapshots, ds.values, ds.frames, ds.labels, mesh=group,
            block_size=win, num_epochs=SAMPLED_SMALL_EPOCHS,
            stats=pipe.stream_stats, max_edges=pipe.max_edges,
            params=params(), device=dev).losses
    return out


def sampled_equivalence(torch, group) -> dict:
    """Every vertex a seed and full fanout on the card: the sampled loss
    stream equals the distributed stream's (rtol 1e-5), as
    ``tests/test_torch_hoststore.py`` pins on the CPU."""
    t0 = time.perf_counter()
    got = sampled_small(torch, "cuda", group, full=True)
    wall = time.perf_counter() - t0
    rel = worst_rel(got["losses"], got["streamed_mesh"])
    if not (rel <= 1e-5 and got["dropped"] == (0, 0)):
        raise SystemExit(f"sampled equivalence: {got['losses']} against "
                         f"streamed_mesh {got['streamed_mesh']} (worst "
                         f"relative {rel:.2e}), dropped {got['dropped']}")
    log(f"[sampled] full fanout (every vertex a seed, fanout = max in-degree "
        f"{got['max_in_degree']}) at N={SAMPLED_SMALL_N} T={SAMPLED_SMALL_T} "
        f"on the card: losses " + ", ".join(f"{v:.6f}" for v in got["losses"])
        + f" against streamed_mesh's, worst relative {rel:.2e} (limit 1e-5; "
        f"{wall:.1f} s)")
    return {"losses": got["losses"], "streamed_mesh": got["streamed_mesh"],
            "worst_relative": rel, "max_in_degree": got["max_in_degree"],
            "wall_s": wall}


def _sampled_shared_rank(rank: int, src: str, store: str, out_dir: str):
    """One of two ranks sharing cuda:0 over gloo: the small sampled run
    (N / 4 seeds, fanouts 10, 10) on the card, then on the CPU, written to
    ``out_dir``."""
    import datetime
    import pickle

    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        res = {dev: sampled_small(torch, dev, dist.group.WORLD,
                                  full=False)["losses"]
               for dev in ("cuda", "cpu")}
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def sampled_shared_card(torch, group) -> dict:
    """P = 2 ranks sharing the one card over gloo, with CUDA tensors: the
    small sampled run on cuda:0, then on the CPU; held to each other, card
    against CPU gloo P = 2 and against the card's P = 1 over NCCL (1e-4
    relative: the rounds are the same samples)."""
    import pickle
    import tempfile

    one = sampled_small(torch, "cuda", group, full=False)["losses"]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        run_ranks(_sampled_shared_rank, 2,
                  (str(SRC), str(Path(d) / "store"), d), RANK_DEADLINE_S)
        ranks_s = time.perf_counter() - t0
        res = []
        for r in range(2):
            with open(Path(d) / f"rank{r}.pkl", "rb") as f:
                res.append(pickle.load(f))
    if res[0] != res[1]:
        raise SystemExit(f"sampled shared card: the ranks disagree {res}")
    card, cpu = res[0]["cuda"], res[0]["cpu"]
    vs_cpu, vs_one = worst_rel(card, cpu), worst_rel(card, one)
    if not (vs_cpu <= TOL_GRAD and vs_one <= TOL_GRAD):
        raise SystemExit(f"sampled shared card: {card} vs CPU {cpu} and "
                         f"P = 1 {one}")
    log(f"[sampled-shared] P = 2 gloo ranks on cuda:0 ({ranks_s:.1f} s with "
        f"their start): losses " + ", ".join(f"{v:.6f}" for v in card)
        + f"; vs CPU gloo P = 2 {vs_cpu:.2e}, vs the card's P = 1 "
        f"{vs_one:.2e} relative (limit {TOL_GRAD})")
    return {"N": SAMPLED_SMALL_N, "T": SAMPLED_SMALL_T, "losses": card,
            "losses_cpu": cpu, "losses_p1": one, "vs_cpu": vs_cpu,
            "vs_p1": vs_one, "ranks_s": ranks_s}


# ----------------------------------------------------- fault tolerance -----

def ft_counts(kernels) -> dict:
    from repro_torch.kernels.segment_spmm import ops as spmm_ops

    out = {k.name: k.launches for k in kernels}
    out["csr_builds"] = spmm_ops.csr_builds
    return out


def ft_zero(kernels) -> None:
    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops

    reset_counts(kernels)
    spmm_ops.csr_builds = 0


def ckpt_costs(torch, tree, d: Path) -> dict:
    """Two ``Checkpointer`` saves of ``tree``: each call's blocking ms (the
    device-to-host copies; the first also allocates the pinned buffers the
    second reuses) and its writer thread's s; the bytes on disk; one
    restore onto the card (ms, synchronized)."""
    from repro_torch.ckpt import Checkpointer

    ck = Checkpointer(d)
    blocking, write = [], []
    for step in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(step, tree)
        blocking.append(time.perf_counter() - t0)
        ck.wait()
        write.append(time.perf_counter() - t0 - blocking[-1])
    on_disk = sum(f.stat().st_size for f in (d / "step_2").iterdir())
    t0 = time.perf_counter()
    ck.restore(2, tree)
    torch.cuda.synchronize()
    return {"save_blocking_ms": blocking[1] * 1e3,
            "first_save_blocking_ms": blocking[0] * 1e3,
            "write_s": write[1], "first_write_s": write[0],
            "bytes_on_disk": on_disk,
            "restore_ms": (time.perf_counter() - t0) * 1e3}


def ft_eager(torch, kernels, obs, ds, pipe, train_losses):
    """Eager fault tolerance at full width, P = 1: ``paper_dyngnn`` on the
    train trace through ``Engine(device="cuda")`` with
    ``CheckpointSpec(every=5)``: a 5-step fit, then ``Engine.resume()`` to
    step 10, every count zeroed just before and read just after (10 steps'
    160 / 12 / 8 / 0 a step), against the uninterrupted 10-step run (and
    the train phase's losses when it ran): losses of steps 5-9 and the
    final parameters within rtol 1e-5 (max |diff| expected 0); then one
    save and restore of the (params, AdamW) tree beside the warm step."""
    import tempfile

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.run import (CheckpointSpec, Engine, ExecutionPlan,
                                 InMemoryDTDG, RunConfig)

    cfg = dataclasses.replace(registry.get_arch("paper_dyngnn").make_config(),
                              num_nodes=ds.num_nodes, num_steps=ds.num_steps)
    src = InMemoryDTDG(ds, pipeline=pipe)

    def engine(steps, **kw):
        return Engine(RunConfig(model=cfg, data=src,
                                plan=ExecutionPlan(num_steps=steps),
                                log_fn=lambda _m: None, **kw), device="cuda")

    t0 = time.perf_counter()
    ref = engine(TRAIN_STEPS).fit()
    ref_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        spec = CheckpointSpec(d, every=FT_EVERY)
        ft_zero(kernels)
        first = engine(FT_EVERY, checkpoint=spec).fit()
        tracer = obs.configure(enabled=True)      # fenced train.step spans
        rest = engine(TRAIN_STEPS, checkpoint=spec).resume()
        obs.configure(enabled=False)
        launches = ft_counts(kernels)
        costs = ckpt_costs(torch, (rest.state.params, rest.state.opt_state),
                           Path(d) / "costs")
    step_ms = [sp.dur_s * 1e3 for sp in tracer.spans()
               if sp.name == "train.step"]
    want = train_launches(cfg.num_layers, ds.num_steps,
                          cfg.checkpoint_blocks)
    check_launches("ft eager", {k: v for k, v in launches.items()
                                if k != "csr_builds"}, want)
    losses = first.losses + rest.losses
    if rest.state.step != TRAIN_STEPS or len(losses) != TRAIN_STEPS:
        raise SystemExit(f"ft eager: resumed to {rest.state.step}, "
                         f"{len(losses)} losses")
    diff = max(abs(a - b) for a, b in zip(losses, ref.losses, strict=True))
    rel = worst_rel(losses, ref.losses)
    with torch.no_grad():
        pdiff = max(float((a - b).abs().max()) for a, b in zip(
            rest.state.params.parameters(), ref.state.params.parameters(),
            strict=True))
        pscale = max(float(b.abs().max())
                     for b in ref.state.params.parameters())
    if not (rel <= 1e-5 and pdiff <= 1e-5 * pscale):
        raise SystemExit(f"ft eager: resumed {losses} vs {ref.losses}, "
                         f"params max|diff| {pdiff}")
    vs_train = (worst_rel(losses, train_losses)
                if train_losses is not None else None)
    if vs_train is not None and not vs_train <= 1e-5:
        raise SystemExit(f"ft eager: {losses} vs the train phase's "
                         f"{train_losses}")
    warm = statistics.median(step_ms)
    log(f"[ft-eager] 5 steps + resume() to 10 vs the uninterrupted run "
        f"({ref_s:.1f} s): losses max|diff| {diff:.3e} ({rel:.2e} rel), "
        f"params max|diff| {pdiff:.3e}"
        + (f", vs the train phase {vs_train:.2e} rel"
           if vs_train is not None else "")
        + f"; launches {launches}; warm step (fenced, median of the "
        f"resumed 5) {warm:.2f} ms; save blocks "
        f"{costs['save_blocking_ms']:.3f} ms, writes in "
        f"{costs['write_s']:.4f} s, {costs['bytes_on_disk']} B on disk, "
        f"restore {costs['restore_ms']:.3f} ms")
    return {"losses": losses, "losses_uninterrupted": ref.losses,
            "max_abs_diff": diff, "params_max_abs_diff": pdiff,
            "vs_train_rel": vs_train, "warm_step_ms": warm,
            "step_ms": step_ms, "launches": launches, **costs}


def ft_stream(torch, kernels, obs, ds, pipe, group):
    """streamed_mesh fault tolerance at full width, P = 1 over the
    one-rank NCCL group: 2 epochs of 4 rounds with
    ``CheckpointSpec(every=2)``, a SIGTERM raised in this process through
    the Engine's ``log_fn`` during round FT_SIGTERM_ROUND (the run stops
    after it, mid-epoch, so the full-N carries cross the checkpoint),
    ``resume()`` to the end; every count zeroed just before and read just
    after (24 / 2 / 2 / 0 and 16 CSR builds a round); both runs' losses
    against the uninterrupted run (fenced, traced: its round's median) at
    rtol 1e-5; then one save and restore of the loop's checkpoint tree
    (params, AdamW, the full-N carries: 144,998,400 B for TM-GCN)."""
    import os
    import signal
    import tempfile

    from repro_torch.configs import registry
    from repro_torch.core import models as tm
    from repro_torch.elastic import tree_bytes
    from repro_torch.run import (CheckpointSpec, Engine, ExecutionPlan,
                                 InMemoryDTDG, RunConfig)

    cfg = dataclasses.replace(registry.get_arch("paper_dyngnn").make_config(),
                              num_nodes=ds.num_nodes, num_steps=ds.num_steps)
    src = InMemoryDTDG(ds, pipeline=pipe)
    plan = ExecutionPlan(mode="streamed_mesh", mesh=group,
                         num_epochs=DSTREAM_EPOCHS)

    def engine(**kw):
        kw.setdefault("log_fn", lambda _m: None)
        return Engine(RunConfig(model=cfg, data=src, plan=plan, **kw),
                      device="cuda")

    tracer = obs.configure(enabled=True)      # fenced round spans
    t0 = time.perf_counter()
    ref = engine().fit()
    ref_s = time.perf_counter() - t0
    obs.configure(enabled=False)
    round_ms = [sp.dur_s * 1e3 for sp in tracer.spans()
                if sp.name == "round"]
    seen = []

    def killer(msg):
        if "dist stream round" in msg:
            if len(seen) == FT_SIGTERM_ROUND:
                os.kill(os.getpid(), signal.SIGTERM)
            seen.append(msg)

    with tempfile.TemporaryDirectory() as d:
        spec = CheckpointSpec(d, every=FT_STREAM_EVERY)
        ft_zero(kernels)
        t0 = time.perf_counter()
        first = engine(checkpoint=spec, log_fn=killer, log_every=1).fit()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rest = engine(checkpoint=spec).resume()
        rest_s = time.perf_counter() - t0
        launches = ft_counts(kernels)
        rounds = len(first.losses) + len(rest.losses)
        params = rest.state.params
        carries = tm.init_carries(cfg, params, device="cuda")
        carry_bytes = tree_bytes(carries)
        costs = ckpt_costs(torch, {"params": params,
                                   "opt": rest.state.opt_state,
                                   "carries": carries}, Path(d) / "costs")
    stop = FT_SIGTERM_ROUND + 1
    rep, rrep = first.rescale_report, rest.rescale_report
    if not (rep.preempted and first.state.step == stop
            and rrep.resumed_from == stop and not rrep.preempted
            and rest.state.step == len(ref.losses)):
        raise SystemExit(f"ft stream: preempted {rep.preempted} at "
                         f"{first.state.step}, resumed from "
                         f"{rrep.resumed_from} to {rest.state.step}")
    check_launches("ft stream", {k: v for k, v in launches.items()
                                 if k != "csr_builds"},
                   {"segment_spmm": 24 * rounds, "banded_ttm": 2 * rounds,
                    "banded_ttm_t": 2 * rounds, "flash_decode": 0})
    if launches["csr_builds"] != 16 * rounds:
        raise SystemExit(f"ft stream: {launches['csr_builds']} CSR builds "
                         f"for {rounds} rounds")
    losses = first.losses + rest.losses
    rel = worst_rel(losses, ref.losses)
    if not rel <= 1e-5:
        raise SystemExit(f"ft stream: {losses} vs {ref.losses}")
    want_carry = cfg.num_layers * (cfg.window - 1) * cfg.num_nodes \
        * cfg.out_dim * 4
    if carry_bytes != want_carry:
        raise SystemExit(f"ft stream: carries {carry_bytes} B, expected "
                         f"{want_carry}")
    med = statistics.median(round_ms)
    log(f"[ft-stream] SIGTERM in round {FT_SIGTERM_ROUND}: stopped at "
        f"cursor {first.state.step} ({first_s:.1f} s), resume() to "
        f"{rest.state.step} ({rest_s:.1f} s); losses vs the uninterrupted "
        f"run ({ref_s:.1f} s) {rel:.2e} rel, max|diff| "
        f"{drift(losses, ref.losses):.3e}; launches {launches}; round "
        f"(fenced, median) {med:.2f} ms; the loop's tree: carries "
        f"{carry_bytes} B, save blocks "
        f"{costs['first_save_blocking_ms']:.2f} ms (pinned buffers "
        f"allocated), then {costs['save_blocking_ms']:.2f} ms, "
        f"writes in {costs['write_s']:.3f} s, {costs['bytes_on_disk']} B "
        f"on disk, restore {costs['restore_ms']:.2f} ms")
    return {"losses": losses, "losses_uninterrupted": ref.losses,
            "worst_rel": rel, "stopped_at": first.state.step,
            "round_ms_median": med, "round_ms": round_ms,
            "carry_bytes": carry_bytes, "launches": launches,
            "first_s": first_s, "resume_s": rest_s, **costs}


def ft_small(torch, dev: str, pool) -> dict:
    """TM-GCN at the full config's widths, N = 65,536, T = 8, block 4,
    ``train_elastic_streamed`` over ``pool`` at widths 2 -> 1 -> 2
    (FT_SCHEDULE), 2 epochs from the seed-7 parameters."""
    from repro_torch import elastic as el
    from repro_torch.configs import registry
    from repro_torch.core import models as tm
    from repro_torch.data.dyngnn import synthetic_dataset

    n, t, nb = FT_SHARED_N, FT_SHARED_T, FT_SHARED_NB
    cfg = dataclasses.replace(registry.get_arch("tmgcn").make_config(),
                              num_nodes=n, num_steps=t, checkpoint_blocks=nb)
    ds = synthetic_dataset(n, t, density=TRAIN_DENSITY,
                           smoothing_mode="mproduct", window=cfg.window,
                           seed=1)
    params = tm.init_params(torch.Generator().manual_seed(7), cfg)
    st = el.train_elastic_streamed(
        cfg, ds.snapshots, ds.values, ds.frames, ds.labels,
        controller=el.RescaleController(initial_p=2, schedule=FT_SCHEDULE),
        pool=pool, num_epochs=DSTREAM_EPOCHS, params=params, device=dev)
    return {"losses": st.losses,
            "events": [(e.block, e.old_p, e.new_p, e.payload_bytes,
                        e.recompose_s) for e in st.report.events],
            "segments": st.report.segments}


def _ft_shared_rank(rank: int, src: str, store: str, out_dir: str):
    """One of two ranks sharing cuda:0 over gloo: the small elastic run on
    the card, written to ``out_dir``."""
    import datetime
    import pickle

    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        res = ft_small(torch, "cuda", dist.group.WORLD)
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def ft_shared_card(torch) -> dict:
    """P = 2 -> 1 -> 2 on two gloo ranks sharing the card: the ranks agree,
    their losses equal ``train_streamed(slice_len=win)`` on the card at
    rtol 1e-5, and each event's payload is ``comm_volume.rescale_payload``
    of the run's trees."""
    import pickle
    import tempfile

    from repro_torch.configs import registry
    from repro_torch.core import models as tm
    from repro_torch.data.dyngnn import synthetic_dataset
    from repro_torch.dist import comm_volume as cv
    from repro_torch.elastic import tree_bytes
    from repro_torch.optim import adamw
    from repro_torch.stream import train_loop as st

    n, t, nb = FT_SHARED_N, FT_SHARED_T, FT_SHARED_NB
    cfg = dataclasses.replace(registry.get_arch("tmgcn").make_config(),
                              num_nodes=n, num_steps=t, checkpoint_blocks=nb)
    ds = synthetic_dataset(n, t, density=TRAIN_DENSITY,
                           smoothing_mode="mproduct", window=cfg.window,
                           seed=1)
    params = tm.init_params(torch.Generator().manual_seed(7), cfg)
    carry_b = tree_bytes(tm.init_carries(cfg, params))
    state_b = tree_bytes(params) + tree_bytes(adamw.init_state(params))
    ref = st.train_streamed(cfg, ds.snapshots, ds.values, ds.frames,
                            ds.labels, num_epochs=DSTREAM_EPOCHS,
                            params=params, slice_len=t // nb,
                            device="cuda").losses
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        run_ranks(_ft_shared_rank, 2,
                  (str(SRC), str(Path(d) / "store"), d), RANK_DEADLINE_S)
        ranks_s = time.perf_counter() - t0
        res = []
        for r in range(2):
            with open(Path(d) / f"rank{r}.pkl", "rb") as f:
                res.append(pickle.load(f))
    if res[0]["losses"] != res[1]["losses"] or \
            res[0]["segments"] != res[1]["segments"]:
        raise SystemExit(f"ft shared card: the ranks disagree {res}")
    got = res[0]
    rel = worst_rel(got["losses"], ref)
    events = [e[:3] for e in got["events"]]
    want = [(1, 2, 1), (3, 1, 2)]
    payload_ok = all(e[3] == int(cv.rescale_payload(carry_b, state_b,
                                                    e[1], e[2]))
                     for e in got["events"])
    if not (rel <= 1e-5 and events == want and payload_ok):
        raise SystemExit(f"ft shared card: losses {got['losses']} vs "
                         f"{ref}, events {got['events']} (carries "
                         f"{carry_b} B, state {state_b} B)")
    log(f"[ft-shared] P = 2 -> 1 -> 2 on 2 gloo ranks sharing cuda:0 "
        f"({ranks_s:.1f} s with their start): losses "
        + ", ".join(f"{v:.6f}" for v in got["losses"])
        + f"; vs train_streamed on the card {rel:.2e} rel; events "
        + ", ".join(f"{b}: {o} -> {p}, {pb} B, recompose {s * 1e3:.1f} ms"
                    for b, o, p, pb, s in got["events"])
        + f" (the law: carries {carry_b} B + state {state_b} B a new rank)")
    return {"N": n, "T": t, "losses": got["losses"], "losses_ref": ref,
            "worst_rel": rel, "events": got["events"],
            "segments": got["segments"], "carry_bytes": carry_b,
            "state_bytes": state_b, "ranks_s": ranks_s}


def ft_launcher(torch) -> dict:
    """The launcher as a subprocess on the card (``--ckpt-dir``, the eager
    schedule at the smoke config: the distributed stream needs a card a
    rank), stopped by a real SIGTERM from this process after its first
    logged step: it exits 0 with a checkpoint, and a relaunch with the
    same ``--ckpt-dir`` resumes and completes; its final loss equals an
    uninterrupted in-process run's."""
    import os
    import signal
    import subprocess
    import tempfile

    from repro_torch.configs import registry
    from repro_torch.run import Engine, ExecutionPlan, RunConfig, \
        SyntheticTrace

    env = dict(os.environ, PYTHONPATH=str(SRC), PYTHONUNBUFFERED="1")
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "paper_dyngnn", "--steps", str(FT_LAUNCH_STEPS),
               "--ckpt-dir", d, "--device", "cuda"]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                env=env, cwd=ROOT)
        lines = []
        try:
            for line in proc.stdout:
                lines.append(line.rstrip())
                if line.startswith("step 0 loss"):
                    proc.send_signal(signal.SIGTERM)
                    break
            rest, _ = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        first_s = time.perf_counter() - t0
        lines += rest.splitlines()
        from repro_torch.ckpt import Checkpointer
        steps = Checkpointer(d).all_steps()
        pre = [ln for ln in lines if ln.startswith("preempted at step")]
        if proc.returncode != 0 or len(steps) != 1 or not pre:
            raise SystemExit("ft launcher: the SIGTERMed run exited "
                             f"{proc.returncode} with checkpoints {steps}:\n"
                             + "\n".join(lines[-20:]))
        t0 = time.perf_counter()
        again = subprocess.run(cmd, capture_output=True, text=True,
                               env=env, cwd=ROOT, timeout=300)
        second_s = time.perf_counter() - t0
    out = again.stdout.splitlines()
    done = [ln for ln in out if ln.startswith("done: ")]
    resumed = [ln for ln in out if ln.startswith("resumed from checkpoint")]
    arch = registry.get_arch("paper_dyngnn")
    cfg = arch.make_smoke_config()
    ref = Engine(RunConfig(
        model=cfg, data=SyntheticTrace(num_nodes=cfg.num_nodes,
                                       num_steps=cfg.num_steps, density=3.0,
                                       churn=0.1, smoothing_mode="mproduct",
                                       window=cfg.window),
        plan=ExecutionPlan(num_steps=FT_LAUNCH_STEPS),
        log_fn=lambda _m: None), device="cuda").fit()
    want = f"done: {FT_LAUNCH_STEPS} steps, final loss {ref.losses[-1]:.4f}"
    if again.returncode != 0 or not done or not done[0].startswith(want) \
            or resumed != [f"resumed from checkpoint step {steps[0]}"]:
        raise SystemExit(f"ft launcher: relaunch exited {again.returncode}: "
                         f"{done} {resumed} (want {want!r})\n"
                         + again.stderr[-2000:])
    log(f"[ft-launcher] SIGTERM after step 0: '{pre[0]}', exit 0 with the "
        f"step-{steps[0]} checkpoint ({first_s:.1f} s); relaunch: "
        f"'{resumed[0]}', '{done[0]}' ({second_s:.1f} s), the "
        f"uninterrupted run's final loss {ref.losses[-1]:.4f}")
    return {"stopped_at": steps[0], "final": done[0],
            "first_s": first_s, "relaunch_s": second_s}


# ------------------------------------------------------------- LM path -----

def lm_path(torch, kernels, obs):
    """Phase 5: Yi-6B at full width through ``ServeEngine.generate``."""
    import numpy as np

    from repro_torch.configs import yi_6b
    from repro_torch.kernels.build import reset_counts
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = yi_6b.make_config()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = ServeEngine(ServeConfig(model=cfg, batch_sizes=(LM_BATCH,),
                                  prompt_len=LM_PROMPT,
                                  max_tokens=LM_TOKENS), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(eng.params))
    log(f"[lm] {cfg.name}: {n_params:,} parameters ({cfg.dtype}) drawn on "
        f"the card in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if n_params != cfg.param_count():
        raise SystemExit(f"lm: {n_params} parameters, the config says "
                         f"{cfg.param_count()}")
    torch.cuda.reset_peak_memory_stats()
    tracer = obs.configure(enabled=True)     # fenced prefill/decode spans
    reset_counts(kernels)
    tokens = eng.generate()
    launches = {k.name: k.launches for k in kernels}
    obs.configure(enabled=False)
    steps = LM_TOKENS - 1
    check_launches("lm", launches, {"segment_spmm": 0, "banded_ttm": 0,
                                    "banded_ttm_t": 0,
                                    "flash_decode": cfg.num_layers * steps})
    r = eng.result()
    if tokens.shape != (LM_BATCH, LM_TOKENS) or not (
            (tokens >= 0) & (tokens < cfg.padded_vocab)).all():
        raise SystemExit(f"lm: bad tokens {tokens.shape}, range "
                         f"[{tokens.min()}, {tokens.max()}]")
    spans = {}
    for sp in tracer.spans():
        spans.setdefault(sp.name, []).append(sp.dur_s * 1e3)
    prefill_ms = spans["serve.prefill"][0]
    decode_ms = spans["serve.decode"]
    if len(decode_ms) != steps:
        raise SystemExit(f"lm: {len(decode_ms)} decode spans, expected "
                         f"{steps}")
    wall = r.query_seconds
    stats = {
        "prefill_ms": prefill_ms,
        "decode_ms_p50": statistics.median(decode_ms),
        "decode_ms_p95": sorted(decode_ms)[int(0.95 * (steps - 1))],
        "decode_tokens_per_s": LM_BATCH * steps / (sum(decode_ms) / 1e3),
        "tokens_per_s": tokens.size / wall, "generate_s": wall,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches["flash_decode"]}
    log(f"[lm] generate: B={LM_BATCH}, prompt {LM_PROMPT}, {LM_TOKENS} "
        f"tokens, {wall:.3f} s -> {stats['tokens_per_s']:.1f} tokens/s "
        f"(fenced spans)")
    log(f"[lm] prefill {prefill_ms:.1f} ms; decode per step p50 "
        f"{stats['decode_ms_p50']:.3f} ms, p95 {stats['decode_ms_p95']:.3f}"
        f" ms over {steps} steps -> {stats['decode_tokens_per_s']:.1f} "
        f"decode tokens/s")
    log(f"[lm] peak device memory {stats['peak_gib']:.2f} GiB; tokens in "
        f"[0, {cfg.padded_vocab}): {tokens.shape}, first row "
        f"{np.asarray(tokens[0, :8]).tolist()}")
    return eng, stats


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def profile_decode(torch, eng):
    """One Yi-6B decode step at the path's shape: warm steady time, then
    one step under ``torch.profiler`` (device busy, idle share, top ops)."""
    from repro_torch.models import lm

    cfg, params = eng.model, eng.params
    gen = torch.Generator(device="cuda").manual_seed(5)
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=gen, device="cuda")
    logits, cache = lm.prefill(cfg, params, prompts, LM_PROMPT + LM_TOKENS)
    tok = torch.argmax(logits, -1)

    def step():
        nonlocal cache, tok
        lg, cache = lm.decode_step(cfg, params, cache, tok)
        tok = torch.argmax(lg, -1)

    steady = alternating_walls(torch, {"step": step}, 8, warm=2)["step"]

    def profiled(fn):
        wall_us, busy, by_name = device_profile(torch, fn)
        fd = sum(sum(v) for n, v in by_name.items() if "flash_decode" in n)
        return wall_us, busy, fd, by_name

    wall_us, busy, fd, by_name = profiled(step)
    weight_bytes = sum(t.nbytes for t in _leaves(params))
    # the K/V rows the profiled step reads, in bf16
    kv_bytes = 2 * cfg.num_layers * int(cache["len"].sum()) \
        * cfg.num_kv_heads * cfg.head_dim * 2
    bound = (weight_bytes + kv_bytes) / 3.35e12 * 1e3
    res = {"steady_ms": steady, "wall_ms": wall_us / 1e3,
           "busy_ms": busy / 1e3, "idle_share": 1 - busy / wall_us,
           "flash_decode_ms": fd / 1e3, "bound_ms": bound,
           "activities": sum(map(len, by_name.values()))}
    log(f"[profile-lm] decode step (warm, host clock + sync, median of 6):"
        f" {steady:.3f} ms; bound {bound:.3f} ms "
        f"({weight_bytes / 1e9:.2f} GB of weights + "
        f"{kv_bytes / 1e9:.2f} GB of K/V at 3.35 TB/s)")
    log(f"[profile-lm] one step under the profiler: wall "
        f"{res['wall_ms']:.3f} ms, device busy {res['busy_ms']:.3f} ms, "
        f"idle share {res['idle_share']:.3f}, {res['activities']} device "
        f"activities, flash_decode {res['flash_decode_ms']:.3f} ms")
    for name, v in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]:
        log(f"[profile-lm]   {sum(v) / 1e3:8.3f} ms  x{len(v):<4d} "
            f"{name[:90]}")
    return res


def fd_excess(dtype: str, got, want32) -> tuple[float, float]:
    """-> (max |kernel - plain fp32|, the largest ratio of a batch row's
    max |diff| to that row's limit; the check passes at <= 1).  A row's
    limit is, in f32, TOL_FD abs + rel x the row's max |plain|; in bf16,
    TOL_FD x the row's max |plain|, scaled to the output alone: the output
    shrinks as 1 / sqrt(cache rows), so a fixed absolute term, or one
    scaled to another row's larger output, would pass zeros."""
    diff = (got - want32).abs().flatten(1).amax(1)
    peak = want32.abs().flatten(1).amax(1)
    limit = TOL_FD[dtype] * (peak if dtype == "bfloat16" else 1.0 + peak)
    return float(diff.max()), float((diff / limit).max())


def dropped_split_lens(lens: list[int], s: int, splits: int) -> list[int]:
    """``cache_len`` with one split's share of each sequence's rows taken
    off its end (at least one row kept; rows with ``cache_len <= 0`` keep
    their meaning): the kernel run on these is the kernel with a split
    dropped."""
    out = []
    for x in lens:
        n = min(x, s)
        out.append(x if x <= 0 else max(n - -(-n // splits), 1))
    return out


def check_flash_decode(torch, timer):
    """Phase 6: the kernel against its plain version, and timed.  Each
    case also shows that its check rejects two faulty outputs made on the
    card: zeros, and the kernel's own output with one split's rows
    dropped."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import ops, ref

    s_path = LM_PROMPT + LM_TOKENS
    cases = [  # name, B, Hq, KVH, D, S, cache_len
        ("path", 8, 32, 4, 128, s_path, [LM_PROMPT + 32] * 8),
        ("path ragged", 8, 32, 4, 128, s_path,
         [1, s_path, 4097, 2000, 3000, 17, 4100, 9999]),
        ("decode_32k", 8, 32, 4, 128, 32768,
         [32768, 1, 30000, 16384, 32767, 5000, 20000, 32768]),
        ("long_500k", 1, 32, 4, 128, 524288, [524288]),
        ("D64 G1", 8, 36, 36, 64, s_path, [LM_PROMPT + 32] * 8),
        ("D256 G1", 8, 16, 16, 256, s_path, [LM_PROMPT + 32] * 8),
        ("G2", 2, 8, 4, 128, 300, [300, 123]),
        ("cache_len 0", 2, 32, 4, 128, s_path, [0, s_path]),
        ("D64 G4", 2, 16, 4, 64, 1000, [1000, 77]),
    ]
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, err_all = [], 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for name, b, hq, kvh, d, s, lens in cases:
            q = torch.randn((b, hq, d), generator=gen, device="cuda"
                            ).to(dtype)
            k = torch.randn((b, s, kvh, d), generator=gen, device="cuda"
                            ).to(dtype)
            v = torch.randn((b, s, kvh, d), generator=gen, device="cuda"
                            ).to(dtype)
            cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got = ops.decode_attention(q, k, v, cl).float()
            want = ref.flash_decode_ref(q, k, v, cl)
            # the plain version's fp32 result before its cast to q's type
            want32 = want if dtype == torch.float32 else \
                ref.flash_decode_ref(q.float(), k.float(), v.float(), cl)
            torch.cuda.synchronize()
            err, ratio = fd_excess(dname, got, want32)
            if not ratio <= 1.0:
                raise SystemExit(f"flash_decode {name} {dname}: kernel "
                                 f"disagrees with its plain version: max "
                                 f"|diff| {err:.3e}, {ratio:.3f} x a row's "
                                 "limit")
            err_all = max(err_all, err)
            pl = ops.plan(b, s, hq, kvh, d, dtype == torch.bfloat16,
                          ops._sm_count(0))
            instance = "tensor cores" if pl[0] == ops.TC_HEADS \
                else "CUDA cores"
            cut = torch.tensor(dropped_split_lens(lens, s, pl[1]),
                               dtype=torch.int32, device="cuda")
            faults = {
                "zeros": fd_excess(dname, torch.zeros_like(got), want32)[1],
                "a split dropped": fd_excess(dname, ops.decode_attention(
                    q, k, v, cut).float(), want32)[1]}
            for fault, fratio in faults.items():
                if fratio <= 1.0:
                    raise SystemExit(
                        f"flash_decode {name} {dname}: the check would "
                        f"pass a kernel that wrote {fault} ({fratio:.3f} x "
                        "a row's limit)")
            # the yardstick: SDPA over (B, KVH, S, D) views with a length
            # mask (all-masked rows give NaN there, so its error is taken
            # over rows with cache_len >= 1)
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            n_rows = [min(x, s) if x > 0 else s for x in lens]
            mask = (torch.arange(s, device="cuda")[None, :]
                    < torch.tensor(n_rows, device="cuda")[:, None]
                    )[:, None, None, :]

            def lib(q=q, kt=kt, vt=vt, mask=mask):
                return F.scaled_dot_product_attention(
                    q[:, :, None, :], kt, vt, attn_mask=mask,
                    enable_gqa=True)[:, :, 0]

            ok = torch.tensor([x > 0 for x in lens], device="cuda")
            lib_err = float((lib() - want).float()[ok].abs().max())
            esize = q.element_size()
            nbytes = 2 * q.nbytes + cl.nbytes \
                + 2 * sum(n_rows) * kvh * d * esize
            b_ms, b_by = bound_ms(nbytes, 4.0 * sum(n_rows) * hq * d)

            def kern(q=q, k=k, v=v, cl=cl):
                return ops.decode_attention(q, k, v, cl)

            row = {
                "case": name, "dtype": dname,
                "B": b, "Hq": hq, "KVH": kvh, "D": d, "S": s,
                "cache_len": lens, "instance": instance,
                "ms": timer(kern), "wrapper_ms": timer(kern, host=True),
                "plain_ms": timer(lambda q=q, k=k, v=v, cl=cl:
                                  ref.flash_decode_ref(q, k, v, cl)),
                "library_ms": timer(lib),
                "ms_write_flush": timer(kern, flush="write"),
                "library_ms_write_flush": timer(lib, flush="write"),
                "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                "err_over_limit": ratio,
                "max_abs_err_vs_plain_in_dtype": float(
                    (got - want.float()).abs().max()),
                "fault_over_limit": faults, "library_max_abs_err": lib_err,
                "plan": pl}
            log(f"[kernel] flash_decode {name} {dname} (B {b}, Hq {hq}, "
                f"KVH {kvh}, D {d}, S {s}, plan {row['plan']}, {instance})"
                f": kernel {row['ms']:.4f} ms (wrapper, host + device "
                f"{row['wrapper_ms']:.4f}), plain "
                f"{row['plain_ms']:.4f}, sdpa {row['library_ms']:.4f}, bound "
                f"{b_ms:.4f} ({b_by}); with a write flush: kernel "
                f"{row['ms_write_flush']:.4f}, sdpa "
                f"{row['library_ms_write_flush']:.4f}")
            log(f"[kernel]   max|err| {err:.3e}, {ratio:.3f} x a row's "
                "limit; faults rejected at x limit: zeros "
                f"{faults['zeros']:.1f}, a split dropped "
                f"{faults['a split dropped']:.1f}; sdpa max|err| "
                f"{lib_err:.2e}")
            rows.append(row)
            del q, k, v, got, want, want32, kt, vt, lib, kern
    return rows, err_all


def lm_parity(torch):
    """Phase 7: Yi-6B's full widths at 2 layers in f32, the card's kernel
    path against the CPU's plain path on the same parameters."""
    import dataclasses

    from repro_torch.configs import yi_6b
    from repro_torch.models import lm
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = dataclasses.replace(yi_6b.make_config(), num_layers=2,
                              dtype=torch.float32)
    sc = ServeConfig(model=cfg, batch_sizes=(2,), prompt_len=256,
                     max_tokens=8)
    gpu = ServeEngine(sc, device="cuda")
    cpu = ServeEngine(sc, params=gpu.params, device="cpu")
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (2, 256 + 8), generator=gen)
    max_len = 256 + 8
    glog, gcache = lm.prefill(cfg, gpu.params, toks[:, :256].cuda(),
                              max_len)
    clog, ccache = lm.prefill(cfg, cpu.params, toks[:, :256], max_len)
    errs = [check_close("lm prefill logits", glog.cpu(), clog, TOL_LOGITS)]
    for t in range(256, 256 + 8):
        glog, gcache = lm.decode_step(cfg, gpu.params, gcache,
                                      toks[:, t].cuda())
        clog, ccache = lm.decode_step(cfg, cpu.params, ccache, toks[:, t])
        errs.append(check_close(f"lm decode step {t - 255} logits",
                                glog.cpu(), clog, TOL_LOGITS))
    limit = TOL_LOGITS * (1.0 + float(clog.abs().max()))
    log(f"[parity-lm] yi-6b widths, 2 layers, f32, B 2, prompt 256: card "
        f"(kernel) vs CPU (plain) logits max |diff| prefill {errs[0]:.2e},"
        f" decode steps {max(errs[1:]):.2e} (limit ~{limit:.2e})")


# ---------------------------------------------------------------- main -----

GROUPS = ("serve", "train", "stream", "partition", "dstream", "hybrid",
          "sampled", "ft", "lm")


def kernel_entry(name: str, source: str, replaces: str, launches: dict,
                 row: dict, **extra) -> dict:
    """One kernel's line of the report: its launches on each path driven
    (and their sum), and the main shape's numbers from ``row``."""
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces,
             "launches": sum(v.get(name, 0) for v in launches.values()),
             "launches_by_path": {p: v.get(name, 0)
                                  for p, v in launches.items()}}
    for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        entry[key] = row[key]
    entry.update(extra)
    return entry


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    groups = GROUPS
    if argv[:1] == ["--only"] and len(argv) == 2:
        groups = tuple(argv[1].split(","))
    if argv and (groups == GROUPS or not set(groups) <= set(GROUPS)
                 or ("partition" in groups and "train" not in groups)):
        print(f"usage: chip_smoke.py [--only {','.join(GROUPS)}] "
              "(partition is held to train's run: name both)",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run it from the root of a checkout (no "
              "src/repro_torch here)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels as kmod
    from repro_torch import obs
    from repro_torch.configs.paper_dyngnn import DATASETS
    from repro_torch.kernels.build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    kernels = list(kmod.ALL)
    t0 = time.perf_counter()
    logs = build_all(kernels)
    log(f"[build] {len(kernels)} kernels built in "
        f"{time.perf_counter() - t0:.1f} s (nvcc, sm_90a, in parallel)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
        return out

    n_nodes, _, max_edges = DATASETS["epinions"]
    timer = Timer(torch)
    launches, report = {}, []
    if "serve" in groups:
        eng, events, launches["serve"] = phase(
            "main path", main_path, torch, kernels, obs, n_nodes, max_edges)
        spmm_rows, spmm_err, skew_err, skew_rows = phase(
            "segment_spmm check", check_spmm, torch, eng, timer)
        ttm = phase("banded_ttm check", check_ttm, torch, n_nodes,
                    eng.model.window, timer)
        step_prof = phase("profile", profile_step, torch, eng)
        phase("plain-path parity", plain_parity, eng, events)
        phase("small-graph parity", small_parity, torch)
        # the engine sits in a reference cycle: collect it now, or its
        # device state stays allocated under the train phase's peak
        del eng, events
        gc.collect()
        torch.cuda.empty_cache()
    train_ds = stream_pipe = None
    if "train" in groups:
        batch, train_stats, train_ds = phase("train path", train_path,
                                             torch, kernels, obs, n_nodes)
        launches["train"] = train_stats["launches"]
        spmm_bwd, ttm_train_rows, ttm_t_rows, ttm_sweep, ttm_t_sweep = \
            phase("train-shape kernel checks", check_backward, torch, batch,
                  n_nodes, 5, timer)
        del batch
        gc.collect()
        torch.cuda.empty_cache()
        train_par = phase("train parity", train_parity, torch)
    if "stream" in groups:
        if train_ds is None:
            t0 = time.perf_counter()
            train_ds = train_trace(n_nodes, 5).build()
            log(f"[stream] trace made on the host in "
                f"{time.perf_counter() - t0:.1f} s (no train phase)")
        stream_stats, stream_pipe = phase("stream path", stream_path, torch,
                                          kernels, obs, train_ds)
        launches["stream"] = stream_stats["launches"]
        stream_checks = phase("stream-shape kernel checks",
                              stream_kernel_checks, torch, stream_pipe, 5,
                              timer)
        gc.collect()
        torch.cuda.empty_cache()
        stream_stats["parity"] = phase("stream parity", stream_parity,
                                       torch)
        stream_stats.update(stream_checks)
    if {"partition", "dstream", "hybrid", "sampled", "ft"} & set(groups):
        import torch.distributed as dist
        group = nccl_group(torch)
        try:
            if "partition" in groups:
                part_stats = phase("partition path", partition_path, torch,
                                   kernels, obs, train_ds, stream_pipe,
                                   group, train_stats, timer)
                launches["partition"] = part_stats["launches"]
                part_fwd, part_bwd = phase("partition-shape kernel checks",
                                           partition_band_checks, torch,
                                           n_nodes, 5, timer)
                gc.collect()
                torch.cuda.empty_cache()
                part_stats["shared_card"] = phase(
                    "partition shared card", partition_shared_card, torch,
                    group)
                part_stats["band_rows"] = part_fwd
                part_stats["band_t_rows"] = part_bwd
            if "dstream" in groups:
                if train_ds is None:
                    t0 = time.perf_counter()
                    train_ds = train_trace(n_nodes, 5).build()
                    log(f"[dstream] trace made on the host in "
                        f"{time.perf_counter() - t0:.1f} s (no train "
                        "phase)")
                dstream_stats = phase("dstream path", dstream_path, torch,
                                      kernels, obs, train_ds, stream_pipe,
                                      group, timer)
                launches["dstream"] = dstream_stats["launches"]
                dstream_stats["shared_card"] = phase(
                    "dstream shared card", dstream_shared_card, torch,
                    group)
            if {"hybrid", "sampled", "ft"} & set(groups) \
                    and train_ds is None:
                t0 = time.perf_counter()
                train_ds = train_trace(n_nodes, 5).build()
                log(f"[hybrid/sampled] trace made on the host in "
                    f"{time.perf_counter() - t0:.1f} s (no train phase)")
            if "hybrid" in groups:
                hybrid_stats = phase("hybrid path", hybrid_path, torch,
                                     kernels, train_ds, group, timer)
                launches["hybrid"] = hybrid_stats["launches"]
                hybrid_stats["shared_card"] = phase(
                    "hybrid shared card", hybrid_shared_card, torch, group)
            if "sampled" in groups:
                sampled_stats = phase("sampled path", sampled_path, torch,
                                      kernels, obs, train_ds, group)
                launches["sampled"] = sampled_stats["launches"]
                sampled_stats["equivalence"] = phase(
                    "sampled equivalence", sampled_equivalence, torch,
                    group)
                sampled_stats["shared_card"] = phase(
                    "sampled shared card", sampled_shared_card, torch,
                    group)
            if "ft" in groups:
                gc.collect()
                torch.cuda.empty_cache()
                if stream_pipe is None:
                    from repro_torch.data.dyngnn import DTDGPipeline
                    t0 = time.perf_counter()
                    stream_pipe = DTDGPipeline(train_ds, nb=TRAIN_NB,
                                               device="cuda")
                    log(f"[ft] pipeline {time.perf_counter() - t0:.1f} s on "
                        "the host (no stream phase)")
                ft_stats = {"eager": phase(
                    "ft eager", ft_eager, torch, kernels, obs, train_ds,
                    stream_pipe, train_stats["losses"]
                    if "train" in groups else None)}
                ft_stats["stream"] = phase("ft stream", ft_stream, torch,
                                           kernels, obs, train_ds,
                                           stream_pipe, group)
                launches["ft"] = {
                    k: ft_stats["eager"]["launches"].get(k, 0)
                    + ft_stats["stream"]["launches"].get(k, 0)
                    for k in ft_stats["eager"]["launches"]}
                gc.collect()
                torch.cuda.empty_cache()
                ft_stats["shared_card"] = phase("ft shared card",
                                                ft_shared_card, torch)
                ft_stats["launcher"] = phase("ft launcher", ft_launcher,
                                             torch)
        finally:
            dist.destroy_process_group()
    del train_ds, stream_pipe
    gc.collect()
    torch.cuda.empty_cache()
    if "lm" in groups:
        lm_eng, lm_stats = phase("lm path", lm_path, torch, kernels, obs)
        launches["lm"] = {"flash_decode": lm_stats["launches"]}
        lm_prof = phase("lm profile", profile_decode, torch, lm_eng)
        del lm_eng
        gc.collect()
        torch.cuda.empty_cache()
        fd_rows, fd_err = phase("flash_decode check", check_flash_decode,
                                torch, timer)
        phase("lm parity", lm_parity, torch)

    if "serve" in groups:
        spmm_main = next(r for r in spmm_rows if r["F"] == 6)  # layer 2
        spmm_main = dict(spmm_main, max_abs_err=spmm_err)
        extra = {"shapes": spmm_rows, "skewed_max_abs_err": skew_err,
                 "skewed": skew_rows,
                 "csr_builds": launches["serve"]["csr_builds"],
                 "state_advance": step_prof}
        if "train" in groups:
            extra["backward"] = spmm_bwd
            extra["csr_builds_train"] = launches["train"]["csr_builds"]
        if "stream" in groups:
            extra["csr_builds_stream"] = launches["stream"]["csr_builds"]
            extra["csr_pair_build"] = stream_stats["csr_pair"]
        if "hybrid" in groups:
            extra["rectangular"] = hybrid_stats["rectangular"]
        report.append(kernel_entry(
            "segment_spmm", "src/repro_torch/csrc/segment_spmm.cu",
            "src/repro/kernels/segment_spmm/segment_spmm.py:55", launches,
            spmm_main, **extra))
        report.append(kernel_entry(
            "banded_ttm", "src/repro_torch/csrc/banded_ttm.cu",
            "src/repro/kernels/mproduct/mproduct.py:54", launches, ttm,
            detail=ttm, **({"train_shapes": ttm_train_rows,
                            "sweep": ttm_sweep}
                           if "train" in groups else {}),
            **({"partition_shapes": part_stats["band_rows"]}
               if "partition" in groups else {})))
    if "train" in groups:
        ttm_t_main = ttm_t_rows[1]     # block 1: dZ (8, N x 6), lead 4, +4
        report.append(kernel_entry(
            "banded_ttm_t", "src/repro_torch/csrc/banded_ttm.cu",
            "src/repro/kernels/mproduct/mproduct.py:54 (its backward; the "
            "TPU package has none)", launches,
            dict(ttm_t_main, max_abs_err=max(r["max_abs_err"]
                                             for r in ttm_t_rows)),
            shapes=ttm_t_rows + ([stream_stats["banded_ttm_t"]]
                                 if "stream" in groups else [])
            + (part_stats["band_t_rows"] if "partition" in groups else []),
            sweep=ttm_t_sweep, train_path=train_stats,
            train_parity=train_par))
    if "stream" in groups:
        # the streamed schedule's own numbers (the kernels' lines above
        # count its launches in their "stream" path)
        log(json.dumps({"stream_path": stream_stats}))
    if "partition" in groups:
        log(json.dumps({"partition_path": {
            k: v for k, v in part_stats.items()
            if k not in ("band_rows", "band_t_rows")}}))
    if "dstream" in groups:
        log(json.dumps({"dstream_path": dstream_stats}))
    if "hybrid" in groups:
        log(json.dumps({"hybrid_path": {
            k: v for k, v in hybrid_stats.items() if k != "rectangular"}}))
        if "serve" not in groups:
            log(json.dumps({"segment_spmm_rectangular":
                            hybrid_stats["rectangular"]}))
    if "sampled" in groups:
        log(json.dumps({"sampled_path": sampled_stats}))
    if "ft" in groups:
        log(json.dumps({"ft_path": ft_stats}))
    if "lm" in groups:
        report.append(kernel_entry(
            "flash_decode", "src/repro_torch/csrc/flash_decode.cu",
            "src/repro/kernels/flash_decode/flash_decode.py:69", launches,
            dict(fd_rows[0], max_abs_err=fd_err), shapes=fd_rows,
            lm_path=lm_stats, decode_profile=lm_prof))
    log("[done] kernels launched on the paths driven and checked against "
        "their plain versions: " + ", ".join(k["name"] for k in report))
    log(json.dumps({"kernels": report}))
    if groups != GROUPS:
        log(f"[done] partial run ({','.join(groups)}): no result line")
        return 0
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
