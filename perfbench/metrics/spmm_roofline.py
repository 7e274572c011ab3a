"""spmm_roofline: ``segment_spmm`` (forward and its backward on the
transposed CSR) against its roofline, in %: the least bytes of a step's
aggregates (``counts.spmm_bytes``) at 3.35 TB/s over the profiler's
device time in the kernel's functions a step (``kernel_names/
segment_spmm``; the recompute's launches are in the time, not in the
bytes).  None where no launch of it is found."""

from perfbench import counts


def read(ctx):
    t = ctx["kernel_seconds"]("segment_spmm") / ctx["profile"]["steps"]
    if t <= 0:
        return None
    return 100.0 * counts.spmm_bytes(ctx["cfg"], ctx["traffic"]) \
        / counts.PEAK_BYTES / t
