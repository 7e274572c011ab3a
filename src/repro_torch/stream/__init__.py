"""Graph-difference snapshot streaming of the port (paper §3.2).

* ``encoder``    — host delta encoder (copy of ``repro.stream.encoder``);
* ``prefetch``   — pinned, non-blocking staging, the prefetch thread on a
  side CUDA stream (``PrefetchIterator``), the on-device
  ``DeltaApplier`` ring the deltas are applied into, and ``SlotStacker``;
* ``train_loop`` — ``advance_slice``, the state-advance forward every
  consumer of the stream shares, and ``train_streamed``, per-snapshot
  (or per-slice) online training over the delta stream;
* ``wire``       — the narrow int8/int16 delta format (copy of
  ``repro.stream.wire``);
* ``sharded``    — the per-shard time-slice streams of snapshot
  partitioning (copy of ``repro.stream.sharded``);
* ``distributed`` — ``train_distributed_streamed``, each rank of a
  process group training on its own delta stream (paper §3.2 x §4.2).
"""
