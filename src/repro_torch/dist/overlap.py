"""Compute/communication overlap for snapshot partitioning (beyond-paper
§6.5 direction).

Port of ``repro.dist.overlap``: the two time models are pure arithmetic,
copied and held equal to the reference's by
``tests/test_torch_dist_stream.py``.

The plain schedule serializes [spatial GCN] -> [all-to-all] -> [temporal]
per layer.  Chunking each redistribution into C feature-sliced
all-to-alls exposes independent chains the latency-hiding scheduler can
run concurrently with compute; the math is unchanged (verified exactly in
tests/test_partitioning.py and, for the port,
tests/test_torch_partition.py).

``overlap_time_model`` is the standard two-phase pipelining bound: with C
chunks the non-dominant phase hides behind the dominant one except for
one chunk's worth of fill/drain.  ``round_time_model`` extends it to the
four phases of one distributed STREAMED round (transfer, spatial, a2a,
temporal) with both the chunked-a2a and the round-level pipelining knob;
the reference's ``benchmarks/overlap_bench.py`` and
``benchmarks/scaling_bench.py`` report its prediction against the
measured pipelined round time.
"""

from __future__ import annotations


def overlap_time_model(t_comp: float, t_comm: float, chunks: int) -> dict:
    """Pipelined execution time of two phases split into ``chunks``.

    serial    = t_comp + t_comm
    pipelined = max(phases) + min(phases) / chunks   (fill + steady state)
    """
    chunks = max(int(chunks), 1)
    serial = t_comp + t_comm
    pipelined = max(t_comp, t_comm) + min(t_comp, t_comm) / chunks
    return {"serial_s": serial, "pipelined_s": pipelined,
            "speedup": serial / pipelined if pipelined > 0 else 1.0,
            "chunks": chunks}


def round_time_model(t_transfer: float, t_spatial: float, t_a2a: float,
                     t_temporal: float, chunks: int = 1,
                     pipeline_rounds: bool = False,
                     a2a_wire_ratio: float = 1.0) -> dict:
    """Steady-state time of ONE distributed streamed round with C chunks.

    The round has four phases (the serial schedule runs them back to
    back — ``stream.distributed``'s default loop):

      transfer   host->device delta staging + delta-apply reconstruction
      spatial    communication-free GCN stage on the local snapshots
      a2a        the two per-layer fixed-volume all-to-alls
      temporal   temporal stage in the vertex-sharded domain

    Two levels of pipelining, matching the execution knobs:

    * ``chunks=C`` (``a2a_chunks``): within the round, the a2a phase is
      split into C feature-sliced collectives that overlap the adjacent
      compute (spatial + temporal), so the inner round time is the
      standard bound ``max(comp, a2a) + min(comp, a2a) / C``;
    * ``pipeline_rounds``: round r+1's transfer phase runs concurrently
      with round r's compute + collectives, so in steady state the
      per-round time is ``max(transfer, inner)``.

    ``a2a_wire_ratio`` scales the a2a phase for wire compression
    (``ExecutionPlan.compression``): pass the modeled compressed/f32 byte
    ratio — ``alltoall_round_payload(..., compression=...) /
    alltoall_round_payload(...)`` — under the bandwidth-bound assumption
    that redistribution time tracks bytes on the wire.  1.0 (default)
    models the uncompressed round; the serial reference keeps the
    UNCOMPRESSED a2a time so ``speedup`` reports the combined
    pipelining + compression gain against today's serial round.

    Degenerate cases are exact: C=1, no round pipelining, and wire ratio
    1.0 reproduce the serial sum; the model is monotone non-increasing
    in C and in the wire ratio.
    """
    chunks = max(int(chunks), 1)
    if a2a_wire_ratio <= 0:
        raise ValueError(f"a2a_wire_ratio must be > 0, "
                         f"got {a2a_wire_ratio}")
    comp = t_spatial + t_temporal
    serial = t_transfer + comp + t_a2a
    t_a2a_wire = t_a2a * a2a_wire_ratio
    # C=1 degenerates exactly: max + min/1 == comp + t_a2a
    inner = max(comp, t_a2a_wire) + min(comp, t_a2a_wire) / chunks
    pipelined = max(t_transfer, inner) if pipeline_rounds \
        else t_transfer + inner
    return {"serial_s": serial, "pipelined_s": pipelined,
            "inner_s": inner, "a2a_wire_ratio": a2a_wire_ratio,
            "speedup": serial / pipelined if pipelined > 0 else 1.0,
            "chunks": chunks, "pipeline_rounds": pipeline_rounds,
            "phases_s": {"transfer": t_transfer, "spatial": t_spatial,
                         "a2a": t_a2a_wire, "temporal": t_temporal}}


def snapshot_partition_forward_overlapped(cfg, group, num_chunks: int = 2):
    """Snapshot-partitioned forward with chunked (overlappable)
    redistributions — identical outputs to the plain schedule.  ``group``
    is the process group (the reference's mesh and its axis)."""
    # imported here: ``obs.calibrate`` imports this module, and
    # ``core.partition`` imports ``obs``
    from repro_torch.core import partition
    return partition.snapshot_partition_forward(cfg, group,
                                                a2a_chunks=num_chunks)
