"""The device trace of a few steady steps, from ``torch.profiler``.

Copied from ``chip_smoke.device_profile`` (a warm-up cycle before the
recorded one, device busy as the union of the activities' spans, retries
on a window that comes back empty) and cut to what the benchmark reads:
each device activity with its span, the recorded steps' wall time and, on
request, the host operations beside them.
"""

from __future__ import annotations

import time

#: windows tried before a trace with no device time fails the run
ATTEMPTS = 3


def record(fn, steps: int, host: bool, any_rank=lambda empty: empty
           ) -> dict:
    """``fn()`` once in the profiler's warm-up cycle, then ``steps`` times
    recorded -> {"wall_s", "steps", "device": [(name, start_us, end_us)],
    "host": [(name, start_us, end_us)] (empty unless ``host``)}.
    ``any_rank(empty)`` tells whether any rank's window came back empty:
    then every rank records again, so all call ``fn`` alike."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host
                                      else [])
    for _ in range(ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.step()
        device, cpu = [], []
        for e in prof.events():
            span = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CUDA:
                if not (getattr(e, "is_user_annotation", False)
                        or e.name.startswith("nccl:")):
                    device.append(span)
            elif host:
                cpu.append(span)
        if not any_rank(busy_us(device) == 0):
            return {"wall_s": wall, "steps": steps, "device": device,
                    "host": cpu}
    raise RuntimeError("profile: the trace holds no device time")


def merged(device: list) -> list[tuple[float, float]]:
    """The union of the activities' spans, as disjoint sorted intervals."""
    out: list[list[float]] = []
    for _, s, e in sorted(device, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(device: list) -> float:
    return sum(e - s for s, e in merged(device))


def top_ops(device: list, k: int = 10) -> list[list]:
    """The k device operations of most time: [[name, seconds], ...]."""
    total: dict[str, float] = {}
    for name, s, e in device:
        total[name] = total.get(name, 0.0) + (e - s) * 1e-6
    return [[n, v] for n, v in sorted(total.items(), key=lambda x: -x[1])
            [:k]]


def idle_gaps(device: list, host: list, k: int = 10) -> list[list]:
    """The k longest gaps between device activities, each named by the
    host operations running at its midpoint (outermost > innermost; the
    profiler's own step range left out):
    [[name, seconds], ...]."""
    iv = merged(device)
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(iv, iv[1:], strict=False)),
                  reverse=True)[:k]
    out = []
    for length, s, e in gaps:
        mid = (s + e) / 2
        inside = sorted((h for h in host if h[1] <= mid <= h[2]
                         and not h[0].startswith("ProfilerStep")),
                        key=lambda h: h[1] - h[2])
        name = "idle" if not inside else (
            inside[0][0] if len(inside) == 1
            else f"{inside[0][0]} > {inside[-1][0]}")
        out.append([name, length * 1e-6])
    return out
