"""device_ops_per_step: device activities (kernels, copies, sets) the
profiler records in a traced step."""


def read(ctx):
    prof = ctx["profile"]
    return len(prof["device"]) / prof["steps"]
