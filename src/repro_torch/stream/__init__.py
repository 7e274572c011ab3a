"""Graph-difference snapshot streaming of the port (paper §3.2).

* ``encoder``    — host delta encoder (copy of ``repro.stream.encoder``);
* ``prefetch``   — pinned, non-blocking staging and the on-device
  ``DeltaApplier`` ring the deltas are applied into;
* ``train_loop`` — ``advance_slice``, the state-advance forward every
  consumer of the stream shares.
"""
