"""step_mfu: the whole train step's share of the card's peak, in %: the
least time the step's frozen work could take (``counts.step_work``: the
larger of FLOPs over 67 TFLOP/s and bytes over 3.35 TB/s) over the window's
mean step time."""

from perfbench import counts


def read(ctx):
    flops, nbytes = counts.step_work(ctx["cfg"], ctx["traffic"])
    return 100.0 * counts.bound_s(flops, nbytes) / ctx["step_s"]
