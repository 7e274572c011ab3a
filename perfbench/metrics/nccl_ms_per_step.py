"""nccl_ms_per_step: rank 0's device time in NCCL kernels a traced step,
in ms (``kernel_names/nccl``).  None where no NCCL kernel ran."""


def read(ctx):
    t = ctx["kernel_seconds"]("nccl") / ctx["profile"]["steps"]
    return 1e3 * t if t > 0 else None
