"""Elastic scaling + preemption handling (port of ``repro.ft.elastic``;
host-only, copied).

* **Re-mesh.**  ``remesh_plan`` picks the (data, model) factorization
  for a changed device count.  Checkpoints hold whole host arrays
  (``repro_torch.ckpt``), so a run restores onto any width.
* **Snapshot-axis elasticity (paper-specific).**  Snapshot partitioning
  needs bsize % P == 0; ``dyngnn_elastic_blocks`` re-blocks the timeline
  (adjusts nb) for a new P, preserving the gradient-checkpoint semantics
  — the communication volume stays O(T*N) at any P, which is the
  paper's argument for why elasticity is cheap under this scheme.
  ``ExecutionPlan.resolved_blocks`` uses it for the distributed stream.
* **Preemption.**  ``PreemptionGuard`` converts SIGTERM into a flag the
  train loop polls; on preemption it saves a final checkpoint and exits
  cleanly (a restart resumes from the data cursor in the checkpoint's
  ``extra``).  A flag is one process's: the elastic loop agrees it over
  the ranks before any of them acts on it (``repro_torch.elastic``).

The live mid-run recomposition built on these pieces — changing the
snapshot-parallel width P without restarting — lives in
``repro_torch.elastic``.  Held equal to the reference by
``tests/test_torch_ft.py`` and ``tests/test_torch_dist_stream.py``.
"""

from __future__ import annotations

import signal
from dataclasses import dataclass


@dataclass(frozen=True)
class MeshPlan:
    data: int
    model: int

    @property
    def chips(self) -> int:
        return self.data * self.model


def remesh_plan(num_chips: int, model_parallel: int = 16,
                min_model: int = 1) -> MeshPlan:
    """Choose (data, model) for a new chip count.

    Keeps model-parallel degree if it divides the chip count; otherwise
    falls back to the largest power-of-two divisor <= requested (TP degree
    must divide head/ff dims, which are powers of two in all our configs).
    """
    m = min(model_parallel, num_chips)
    while m > min_model and num_chips % m != 0:
        m //= 2
    return MeshPlan(data=num_chips // m, model=m)




def dyngnn_elastic_blocks(num_steps: int, num_procs: int,
                          target_bsize: int) -> tuple[int, int]:
    """(nb, bsize) for a new processor count: bsize must be a multiple of P
    and divide T; prefer the largest bsize <= target (fewer blocks = less
    recompute + better GD benefit ratio (bsize-P)/bsize, §6.2).

    Raises when no legal blocking exists (``num_steps % num_procs != 0``):
    every returned ``(nb, bsize)`` satisfies ``nb * bsize == num_steps``,
    so callers never receive a blocking that does not tile the timeline —
    pad the trace or change P instead.
    """
    if num_steps < 1 or num_procs < 1:
        raise ValueError(f"num_steps ({num_steps}) and num_procs "
                         f"({num_procs}) must be >= 1")
    if num_steps % num_procs:
        raise ValueError(
            f"timeline of {num_steps} steps cannot be tiled into blocks "
            f"divisible by {num_procs} processors (num_steps % num_procs "
            "!= 0); pad the trace or pick a P that divides it")
    best = None
    for nb in range(1, num_steps + 1):
        if num_steps % nb:
            continue
        bsize = num_steps // nb
        if bsize % num_procs:
            continue
        if bsize <= target_bsize:
            best = (nb, bsize)
            break
    if best is None:
        # fall back to bsize == P (minimum legal block; tiles exactly
        # because num_procs divides num_steps)
        nb = num_steps // num_procs
        return nb, num_procs
    return best


def _chainable(prev) -> bool:
    """A previous handler worth forwarding to: a real Python callable,
    not the SIG_DFL/SIG_IGN sentinels and not the default SIGINT handler
    (chaining that one would re-raise KeyboardInterrupt — exactly the
    hard kill the guard exists to absorb)."""
    return (callable(prev)
            and prev not in (signal.SIG_DFL, signal.SIG_IGN,
                             signal.default_int_handler))


class PreemptionGuard:
    """SIGTERM (and optionally SIGINT) -> graceful checkpoint-and-exit flag.

    Composes instead of clobbering: a previously installed handler still
    runs after the flag is set, so nested guards all observe the signal
    and wrapping launchers keep their own cleanup hooks.  ``__exit__``
    restores exactly the handlers it replaced, so nested guards unwind
    in LIFO order.
    """

    def __init__(self, catch_sigint: bool = False):
        self.preempted = False
        self._signals = (signal.SIGTERM,) + (
            (signal.SIGINT,) if catch_sigint else ())
        self._orig: dict = {}

    def __enter__(self):
        for sig in self._signals:
            prev = signal.getsignal(sig)

            def handler(signum, frame, _prev=prev):
                self.preempted = True
                if _chainable(_prev):
                    _prev(signum, frame)

            self._orig[sig] = signal.signal(sig, handler)
        return self

    def __exit__(self, *exc):
        for sig, orig in self._orig.items():
            signal.signal(sig, orig)
        self._orig.clear()
        return False
