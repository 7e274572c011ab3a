"""Shard-aware streaming for snapshot partitioning (paper §4.2).

Host numpy, a copy of ``repro.stream.sharded`` whose streams are held
byte-identical to the reference's by ``tests/test_torch_dist_stream.py``.
Under the port's one process per rank, rank r encodes only its own
stream: ``encode_time_sliced(..., shards=[r])`` gives the reference's
``encode_time_sliced(...)[r]`` (the encode is deterministic given the
trace and its statistics).

Under snapshot partitioning, processor s of P owns a contiguous slice of
``bsize/P`` steps inside every checkpoint block.  Broadcasting the global
delta stream would ship every delta to every device; instead each shard
receives ONLY its own time-slices, encoded self-contained: the first step
of each slice ships full (the device holds nothing to diff against at a
slice boundary — the per-shard analogue of §6.2's block-boundary rule),
and the rest ship as deltas sized by the same trace statistics.

The per-shard payload therefore scales 1/P with the shard count (up to
the extra slice-boundary full snapshots), which is what
the reference's ``benchmarks/graphdiff_bench.py`` reports.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graphdiff import FullSnapshot, SnapshotDelta
from repro_torch.stream import encoder as enc


def shard_slice_steps(num_steps: int, block_size: int, num_shards: int,
                      shard: int) -> list[int]:
    """Global step indices owned by ``shard`` (contiguous per block)."""
    if block_size % num_shards != 0:
        raise ValueError(f"block_size {block_size} must divide into "
                         f"{num_shards} shards")
    bsl = block_size // num_shards
    steps: list[int] = []
    for b0 in range(0, num_steps, block_size):
        start = b0 + shard * bsl
        steps.extend(range(start, min(start + bsl, num_steps)))
    return steps


def encode_time_sliced(snapshots: list[np.ndarray],
                       values: list[np.ndarray] | None,
                       num_nodes: int, max_edges: int, block_size: int,
                       num_shards: int,
                       stats: enc.DeltaStats | None = None,
                       start_step: int = 0, wire: str = "none",
                       shards: list[int] | None = None
                       ) -> list[list[FullSnapshot | SnapshotDelta]]:
    """Per-shard streams: ``out[s][i]`` transfers shard s's i-th owned step.

    Each shard's sub-sequence is encoded with block boundaries at its
    slice starts (block size ``bsize/P``), so every slice is decodable
    from an empty device buffer.  Deltas within a slice reuse the global
    stats pads — churn between consecutive owned steps equals global
    consecutive-step churn because slices are contiguous.

    ``start_step`` (a checkpoint-block boundary) starts the streams
    mid-timeline: the elastic rescale subsystem (``repro.elastic``)
    re-slices the remaining trace for a NEW shard count from the next
    block boundary.  This is legal at exactly block granularity because
    every slice opens with a self-contained ``FullSnapshot`` — no shard
    ever needs decoder state from before the boundary, so the re-sliced
    tail is identical to the tail of a from-zero encoding.

    ``wire="int8"`` puts every delta on the narrow ``stream.wire``
    format (slice-boundary fulls stay lossless f32 — see
    ``IncrementalEncoder``).

    ``shards`` encodes only those shards' streams, in that order (all
    ``num_shards`` when None): a rank process encodes its own.
    """
    if start_step % block_size:
        raise ValueError(f"start_step {start_step} must be a checkpoint-"
                         f"block boundary (multiple of {block_size})")
    if start_step:
        snapshots = snapshots[start_step:]
        values = values[start_step:] if values is not None else None
    bsl = block_size // num_shards
    if stats is None:
        stats = enc.measure_stats(snapshots, num_nodes, block_size,
                                  max_edges)
    out = []
    for s in (range(num_shards) if shards is None else shards):
        steps = shard_slice_steps(len(snapshots), block_size, num_shards, s)
        snaps_s = [snapshots[t] for t in steps]
        vals_s = [values[t] for t in steps] if values is not None else None
        out.append(enc.encode_stream_fast(snaps_s, vals_s, num_nodes,
                                          max_edges, bsl, stats,
                                          wire=wire))
    return out


def sharded_stream_bytes(shard_streams: list[list]) -> int:
    """Total bytes crossing the host->device links, all shards summed."""
    return sum(item.payload_bytes for s in shard_streams for item in s)
