"""Snapshot-axis elasticity (port of part of ``repro.ft.elastic``).

Snapshot partitioning needs bsize % P == 0; ``dyngnn_elastic_blocks``
re-blocks the timeline (adjusts nb) for a new P, preserving the
gradient-checkpoint semantics — the communication volume stays O(T*N) at
any P, which is the paper's argument for why elasticity is cheap under
this scheme.  ``ExecutionPlan.resolved_blocks`` uses it for the
distributed stream.  Pure arithmetic, copied and held equal to the
reference's by ``tests/test_torch_dist_stream.py``.

The rest of the reference module — ``remesh_plan``, ``MeshPlan`` and the
SIGTERM ``PreemptionGuard`` — waits for ROADMAP Queue 1, item 8.
"""

from __future__ import annotations


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
