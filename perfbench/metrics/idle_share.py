"""idle_share: the share of the traced steps' wall time in which no device
activity runs, in %.  Source: the device-only ``torch.profiler`` window of
a few steady steps (busy = the union of the activities' spans)."""

from perfbench import profiling


def read(ctx):
    prof = ctx["profile"]
    busy = profiling.busy_us(prof["device"]) * 1e-6
    return 100.0 * max(0.0, 1.0 - busy / prof["wall_s"])
