"""a2a_remote_gb_per_step: rank 0's ``partition.a2a_remote_bytes``
counter over the window, per step, in 1e9 bytes (the all-to-alls' bytes
that leave the rank: forward, recompute and backward).  None without
all-to-alls."""


def read(ctx):
    b = ctx["counters"].get("partition.a2a_remote_bytes", 0)
    if not b:
        return None
    return b / ctx["window_steps"] / 1e9
