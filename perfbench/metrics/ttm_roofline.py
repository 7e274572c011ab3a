"""ttm_roofline: ``banded_ttm`` and ``banded_ttm_t`` (TM-GCN's M-product,
forward and backward) against their roofline, in %: ``counts.ttm_bytes``
at 3.35 TB/s over the profiler's device time in the kernels' functions a
step (``kernel_names/banded_ttm``).  None where no launch is found."""

from perfbench import counts


def read(ctx):
    t = ctx["kernel_seconds"]("banded_ttm") / ctx["profile"]["steps"]
    nbytes = counts.ttm_bytes(ctx["cfg"], ctx["traffic"])
    if t <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / counts.PEAK_BYTES / t
