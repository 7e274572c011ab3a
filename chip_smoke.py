#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU (an H100) and check it.

    python3 chip_smoke.py

Run from the root of a checkout.  It puts ``src`` on ``sys.path`` itself and
imports nothing of JAX or of the JAX package ``repro``.  Phases, each of
which exits non-zero on failure:

1. the card's name and power limit (``nvidia-smi``), then one ``nvcc`` per
   CUDA source of ``src/repro_torch/csrc``, all started together;
2. the main path: online TM-GCN serving (``paper_dyngnn``) at the full
   config's widths at the epinions scale (``DATASETS["epinions"]`` of
   ``configs/paper_dyngnn.py``: N = 755,200 nodes, 2,097,152 edge slots),
   16 windows of a 3.4 M-event synthetic CTDG stream — through
   ``repro_torch.serve.ServeEngine(device="cuda")``, whose kernel wrappers
   launch the CUDA kernels because the tensors lie on the card; every
   kernel's launch count and the CSR build count are zeroed just before
   and read just after (2 layers x 16 windows = 32 launches of each
   kernel, 16 CSR builds: one per snapshot); then node queries at batch
   1, 8, 64 and link queries on 64 pairs;
3. each kernel held to its plain PyTorch version (``ref.py``, called by
   name) on the card at the main path's shapes (the last window's graph;
   segment SpMM at the path's F = 2 and 6 and at F = 9 and 32, which run
   its generic instance (scalar and float4), then on a fully skewed
   graph, each shown to reject zeros and the kernel run with each row's
   last edge dropped),
   and timed beside its bound, its plain version, one PyTorch library
   call computing the same function (a yardstick the port never calls)
   and the previous design (kept in the sources, reached by no wrapper);
   the state-advance step timed in turns with the previous path (a CSR
   build per layer, the thread-per-row kernel), then profiled;
4. the same 16 windows replayed through a ``device="cpu"`` engine — where
   the wrappers run the plain versions — and its embeddings and
   last-window queries held to the card's; then small-graph serving of
   all three models, card against CPU, after every window;
5. the LM path: Yi-6B at full width (32 layers, d 4096, 32 query heads
   over 4 KV heads, D 128, bf16, random weights drawn on the card from a
   seed) served through ``ServeEngine(device="cuda").generate()``: one
   wave of 8 prompts of 4,096 tokens (prefill takes the query-chunked
   path), 64 greedy tokens; every kernel's count is zeroed just before
   and read just after (32 layers x 63 decode steps = 2,016 launches of
   ``flash_decode``, none of the dyngnn kernels); prefill ms, decode ms
   per step (fenced spans), tokens/s, peak device memory; then one decode
   step alone and under ``torch.profiler``, each in turns with the
   previous ``flash_decode``;
6. ``flash_decode`` held to its plain version at the path's shape (B 8,
   S 4,160, ragged ``cache_len`` with 1 and S), at ``decode_32k``'s
   (S 32,768) and ``long_500k``'s (B 1, S 524,288) lengths, at D 64 and
   D 256 with G 1 (MiniCPM, Gemma), at G 2 (a head tile of 16, 14
   padded), with a ``cache_len = 0`` row and at D 64 with G 4, each in
   bf16 (G > 1 on the tensor-core instance) and f32 (CUDA cores); at
   each, the check is shown to reject zeros and the kernel's output with
   one split's rows dropped; each timed beside its bound, its plain
   version, ``scaled_dot_product_attention`` (a yardstick the port never
   calls) and the previous design (wrapper and CUDA-core kernel);
7. Yi-6B's full widths at 2 layers in f32, card (kernel) against a
   ``device="cpu"`` engine's parameters (plain version): prefill logits
   and 8 teacher-forced decode steps' logits.

Tolerances: segment SpMM 1e-4 (abs and rel; fp32 sums in another order
than the plain ``index_add_``), banded TTM 1e-5 (abs and rel; the same
fp32 window sum), served scores 1e-4 (the whole stack, two layers);
flash decode, against the plain version's fp32 result, batch row by batch
row: 1e-4 abs and rel in f32 (``tests/test_kernels.py``'s), and in bf16
1e-2 x the row's max |plain|, no absolute term (2.56 times the worst
rounding of a bf16 output, 2^-8 of its size; the output shrinks as
1 / sqrt(cache rows), so a fixed term would pass zeros at long caches); LM logits 1e-4 (abs and rel; fp32 sums
of 4,096- and 11,008-long products taken in another order, TF32 off).
Kernel times are device time only (each call queued behind a device
sleep); ``wrapper_ms`` is the wrapper's host time plus device time.

Prints the card line, the per-phase numbers, one JSON line of the kernels
and, last, ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository around it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

TOL_SPMM = 1e-4
TOL_TTM = 1e-5
TOL_SCORES = 1e-4
TOL_FD = {"float32": 1e-4, "bfloat16": 1e-2}
TOL_LOGITS = 1e-4

NUM_EVENTS = 3_400_000       # ~2.0 M alive edges at the last window
NUM_WINDOWS = 16
BLOCK_SIZE = 8
QUERY_REPS = 30

LM_BATCH = 8
LM_PROMPT = 4096
LM_TOKENS = 64


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# ------------------------------------------------------------ timing -------

class Timer:
    """Median CUDA-event time of ``fn`` over repeated calls, with the L2
    cache flushed before each call (the main path finds its inputs cold).
    The flush reads 64 MB, so L2 is left full of clean lines, as the ops
    before a kernel on the path leave it (weights read by the projections,
    say).  ``flush="write"`` zeroes 64 MB instead, as this script's timer
    once did: the timed call then also writes the flush's dirty lines
    back, which no caller on the path makes it do; it is kept to compare
    with readings taken that way.

    By default each call is queued behind a ~0.6 ms device sleep, so the
    host time a wrapper spends before its launch is hidden: the reading is
    device time only.  With ``host=True`` the device is idle when the
    start event is recorded, so the reading is the wrapper's host time
    before its launch plus the device time."""

    def __init__(self, torch, reps: int = 20):
        self.torch = torch
        self.reps = reps
        self._read = torch.ones(16 << 20, dtype=torch.float32,
                                device="cuda")
        self._write = torch.empty(64 << 20, dtype=torch.uint8,
                                  device="cuda")

    def __call__(self, fn, host: bool = False, flush: str = "read"
                 ) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(self.reps):
            if flush == "read":
                self._read.sum()
            else:
                self._write.zero_()
            if host:
                torch.cuda.synchronize()
            else:
                torch.cuda._sleep(1_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound_ms(nbytes: float, flops: float, peak_flops: float = 67e12,
             bw: float = 3.35e12) -> tuple[float, str]:
    """Least time on an H100 SXM (3.35 TB/s; fp32 outside the tensor cores
    67 TFLOP/s): the larger of bytes / bandwidth and ops / peak."""
    t_b, t_f = nbytes / bw * 1e3, flops / peak_flops * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


@contextlib.contextmanager
def patched(obj, name: str, value):
    """``obj.name = value`` inside the block (the previous designs, timed on
    the path beside the kernels in one run)."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def alternating_walls(torch, variants: dict, rounds: int, warm: int = 1
                      ) -> dict:
    """Host-clock ms of each variant's call (ending in a sync), the
    variants taken in turns so the host's drift falls on all alike ->
    {name: median over rounds - warm}."""
    walls = {k: [] for k in variants}
    for _ in range(rounds):
        for k, fn in variants.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[k].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v[warm:]) for k, v in walls.items()}


# ------------------------------------------------------------ serving ------

def serve_run(device: str, params, n: int, events, max_edges: int,
              num_windows: int):
    """Push each window's events, advance it; -> (engine, per-window ms)."""
    from repro_torch.configs import registry
    from repro_torch.core.ctdg import EventStream
    from repro_torch.serve import IngestSpec, ServeConfig, ServeEngine

    spec = IngestSpec(num_windows=num_windows, policy="snapshot",
                      time_range=(float(events.time.min()),
                                  float(events.time.max())),
                      block_size=BLOCK_SIZE, max_edges=max_edges)
    cfg = dataclasses.replace(
        registry.get_arch("paper_dyngnn").make_config(), num_nodes=n)
    eng = ServeEngine(ServeConfig(arch="paper_dyngnn", model=cfg,
                                  ingest=spec), params=params,
                      device=device)
    win = spec.window_of(events.time)
    cuts = [0] + [int((win <= k).sum()) for k in range(num_windows)]
    advance_ms = []
    for k in range(num_windows):
        sl = slice(cuts[k], cuts[k + 1])
        eng.ingest(EventStream(events.src[sl], events.dst[sl],
                               events.time[sl], events.kind[sl], n))
        t0 = time.perf_counter()
        eng.advance(1)
        advance_ms.append((time.perf_counter() - t0) * 1e3)
    return eng, advance_ms


def percentiles(ms: list[float]) -> str:
    return (f"p50 {statistics.median(ms):.3f} ms, "
            f"p95 {sorted(ms)[int(0.95 * (len(ms) - 1))]:.3f} ms")


def check_launches(path: str, launches: dict, want: dict) -> None:
    log(f"[{path}] launches on the path: {launches}")
    for name, n in want.items():
        if launches[name] != n:
            raise SystemExit(f"kernel {name}: {launches[name]} launches on "
                             f"the {path} path, expected {n}")


def main_path(torch, kernels, obs, n_nodes: int, max_edges: int):
    """Phase 2: the full-width serving run on the kernel path."""
    import numpy as np

    from repro_torch.core.ctdg import synthetic_ctdg
    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops

    t0 = time.perf_counter()
    events = synthetic_ctdg(n_nodes, NUM_EVENTS, delete_frac=0.2, seed=0)
    log(f"[serve] {len(events)} events generated on the host in "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    tracer = obs.configure(enabled=True)     # fenced phase spans
    reset_counts(kernels)
    spmm_ops.csr_builds = 0
    eng, advance_ms = serve_run("cuda", None, n_nodes, events, max_edges,
                                NUM_WINDOWS)
    launches = {k.name: k.launches for k in kernels}
    builds = spmm_ops.csr_builds
    obs.configure(enabled=False)
    check_launches("serve", launches, {"segment_spmm": 2 * NUM_WINDOWS,
                                       "banded_ttm": 2 * NUM_WINDOWS,
                                       "flash_decode": 0})
    log(f"[serve] CSR builds on the path: {builds} (one per snapshot; "
        f"{launches['segment_spmm']} segment_spmm launches read them)")
    if builds != NUM_WINDOWS:
        raise SystemExit(f"segment_spmm: {builds} CSR builds in "
                         f"{NUM_WINDOWS} windows, expected {NUM_WINDOWS}")
    launches["csr_builds"] = builds
    alive = int(eng.applier.current[1].sum())
    r = eng.result()
    log(f"[serve] windows={r.windows_advanced} alive edges at the last "
        f"window={alive} resyncs={r.resyncs}")
    log(f"[serve] ingest+advance {r.ingest_seconds:.3f} s -> "
        f"{r.events_per_s:.0f} events/s")
    log("[serve] advance ms per window: "
        + ", ".join(f"{v:.1f}" for v in advance_ms))
    phases = {}
    for sp in tracer.spans():
        phases.setdefault(sp.name, []).append(sp.dur_s * 1e3)
    log("[serve] per-window phases (fenced spans, median / max ms): "
        + ", ".join(f"{name.split('.')[-1]} "
                    f"{statistics.median(phases[name]):.1f} / "
                    f"{max(phases[name]):.1f}"
                    for name in ("serve.encode", "serve.stage",
                                 "serve.apply", "serve.step")))
    log(f"[serve] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")

    rng = np.random.default_rng(1)
    for b in (1, 8, 64):
        lat = []
        for _ in range(QUERY_REPS):
            ids = rng.integers(0, n_nodes, b)
            t0 = time.perf_counter()
            out = eng.query_nodes(ids)
            lat.append((time.perf_counter() - t0) * 1e3)
            if out.shape != (b, 2) or not np.isfinite(out).all():
                raise SystemExit(f"query_nodes batch {b}: bad scores "
                                 f"{out.shape}")
        log(f"[query] nodes batch {b}: {percentiles(lat)}")
    lat = []
    for _ in range(QUERY_REPS):
        pairs = rng.integers(0, n_nodes, (64, 2))
        t0 = time.perf_counter()
        out = eng.query_links(pairs)
        lat.append((time.perf_counter() - t0) * 1e3)
        if out.shape != (64, 2) or not np.isfinite(out).all():
            raise SystemExit(f"query_links: bad logits {out.shape}")
    log(f"[query] links 64 pairs: {percentiles(lat)}")
    return eng, events, launches


# ------------------------------------------------------- kernel checks -----

def check_close(name: str, got, want, tol: float) -> float:
    err = float((got - want).abs().max())
    limit = tol + tol * float(want.abs().max())
    if not (err <= limit):
        raise SystemExit(f"{name}: kernel disagrees with its plain version:"
                         f" max |diff| {err:.3e} > {limit:.3e}")
    return err


def spmm_faults(name: str, ops, x, row_ptr, col, w, want
                ) -> dict:
    """Show that the segment SpMM check rejects two faulty outputs made on
    the card: zeros, and the kernel run with each row's last edge dropped
    (its weight set to 0) -> {fault: max |diff| over the limit}."""
    last = row_ptr[1:] - 1
    last = last[row_ptr[1:] > row_ptr[:-1]].long()
    w_cut = w.clone()
    w_cut[last] = 0.0
    limit = TOL_SPMM * (1.0 + float(want.abs().max()))
    faults = {
        "zeros": float(want.abs().max()) / limit,
        "last edge dropped": float((ops.segment_spmm_csr(
            x, row_ptr, col, w_cut) - want).abs().max()) / limit}
    for fault, ratio in faults.items():
        if ratio <= 1.0:
            raise SystemExit(f"segment_spmm {name}: the check would pass a "
                             f"kernel that wrote {fault} ({ratio:.3f} x "
                             "its limit)")
    return faults


def previous_spmm(ops):
    """The previous design of segment SpMM, for timing beside the kernel:
    the thread-per-row kernel (kept in ``csrc/segment_spmm.cu``, reached
    by no wrapper), on a prebuilt CSR and with the per-call CSR build its
    wrapper made."""
    import torch

    def on_csr(x, row_ptr, col, w):
        out = torch.empty_like(x)
        ops.KERNEL.launch_uncounted(ops.ROWTHREAD_SYMBOL, x.device,
                                    x.data_ptr(), row_ptr.data_ptr(),
                                    col.data_ptr(), w.data_ptr(),
                                    out.data_ptr(), x.shape[0], x.shape[1])
        return out

    def with_build(x, edges, w, n):
        return on_csr(x, *ops.build_csr(edges, w, n))

    return on_csr, with_build


def check_spmm(torch, eng, timer):
    """Segment SpMM on the last window's graph (with self-loops), at the
    path's F = 2 (layer 1) and 6 (layer 2) and the generic instance's
    F = 9 and 32, then on a fully skewed graph; each held to the plain
    version, shown to reject two faulty outputs, and timed beside the
    previous design."""
    from repro_torch.graph import segment
    from repro_torch.kernels.segment_spmm import ops, ref
    from repro_torch.stream.train_loop import (make_self_loops,
                                               slice_weights_with_loops)

    old_csr, old_build = previous_spmm(ops)
    n = eng.model.num_nodes
    edges, mask = eng.applier.current
    # snapshot policy: every valid lane's value is 1, so values == mask
    e_full, w_full = slice_weights_with_loops(
        n, *make_self_loops(n, edges.device), edges[None], mask[None],
        mask[None])
    e, w = e_full[0], w_full[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    valid = w != 0
    deg = torch.stack([segment.in_degree(e, n, valid),
                       segment.out_degree(e, n, valid)], dim=1)
    row_ptr, col, wc = ops.build_csr(e, w, n)
    nnz = int(row_ptr[-1])
    results = []
    err_all = 0.0
    build_ms = timer(lambda: ops.build_csr(e, w, n))
    for f, x in ((2, deg.contiguous()),
                 (6, torch.randn((n, 6), generator=gen, device="cuda")),
                 (9, torch.randn((n, 9), generator=gen, device="cuda")),
                 (32, torch.randn((n, 32), generator=gen, device="cuda"))):
        got = ops.segment_spmm_csr(x, row_ptr, col, wc)
        want = ref.segment_spmm_csr_ref(x, row_ptr, col, wc)
        old = old_csr(x, row_ptr, col, wc)
        torch.cuda.synchronize()
        err = check_close(f"segment_spmm F={f}", got, want, TOL_SPMM)
        old_err = check_close(f"segment_spmm (previous design) F={f}", old,
                              want, TOL_SPMM)
        faults = spmm_faults(f"F={f}", ops, x, row_ptr, col, wc,
                             want)
        err_all = max(err_all, err)
        csr = torch.sparse_csr_tensor(row_ptr, col[:nnz], wc[:nnz],
                                      size=(n, n), check_invariants=False)
        lib_err = float((torch.sparse.mm(csr, x) - want).abs().max())
        nbytes = (x.nbytes + row_ptr.nbytes + nnz * 8 + got.nbytes)
        b_ms, b_by = bound_ms(nbytes, 2.0 * nnz * f)

        def kern(x=x):
            return ops.segment_spmm_csr(x, row_ptr, col, wc)

        row = {
            "F": f, "edges": int(e.shape[0]), "nnz": nnz,
            "ms": timer(kern), "wrapper_ms": timer(kern, host=True),
            "with_csr_ms": timer(lambda x=x: ops.segment_spmm(x, e, w, n)),
            "with_csr_wrapper_ms": timer(
                lambda x=x: ops.segment_spmm(x, e, w, n), host=True),
            "old_ms": timer(lambda x=x: old_csr(x, row_ptr, col, wc)),
            "old_with_csr_wrapper_ms": timer(
                lambda x=x: old_build(x, e, w, n), host=True),
            "csr_build_ms": build_ms,
            "plain_ms": timer(lambda x=x: ref.segment_spmm_csr_ref(
                x, row_ptr, col, wc)),
            "library_ms": timer(lambda x=x, csr=csr: torch.sparse.mm(csr,
                                                                     x)),
            "ms_write_flush": timer(kern, flush="write"),
            "old_ms_write_flush": timer(lambda x=x: old_csr(
                x, row_ptr, col, wc), flush="write"),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            "old_max_abs_err": old_err, "fault_over_limit": faults,
            "library_max_abs_err": lib_err}
        log(f"[kernel] segment_spmm F={f}: kernel {row['ms']:.4f} ms "
            f"(wrapper, host + device {row['wrapper_ms']:.4f}; with its "
            f"CSR build {row['with_csr_ms']:.4f}, wrapper "
            f"{row['with_csr_wrapper_ms']:.4f}), previous design "
            f"{row['old_ms']:.4f} (with its per-call build, wrapper "
            f"{row['old_with_csr_wrapper_ms']:.4f}), CSR build "
            f"{build_ms:.4f}, plain {row['plain_ms']:.4f}, torch.sparse.mm "
            f"{row['library_ms']:.4f}, bound {b_ms:.4f} ({b_by}); with "
            f"a write flush: kernel {row['ms_write_flush']:.4f}, previous "
            f"design {row['old_ms_write_flush']:.4f}")
        log(f"[kernel]   max|err| {err:.2e} (previous design {old_err:.2e}); "
            f"faults rejected at x limit: zeros {faults['zeros']:.1f}, last"
            f" edge dropped {faults['last edge dropped']:.1f}")
        results.append(row)
    # fully skewed: every edge into one destination, pad lanes at (0, 0);
    # weights in [0.5, 1), so the one dropped edge of the fault below
    # stands out of a row summed over 32 K edges
    m = 1 << 16
    src = torch.randint(0, n, (m,), generator=gen, device="cuda")
    sk = torch.stack([src, torch.full_like(src, 7)], 1).to(torch.int32)
    sw = 0.5 + 0.5 * torch.rand((m,), generator=gen, device="cuda")
    sw[m // 2:] = 0.0
    sk[m // 2:] = 0
    s_csr = ops.build_csr(sk, sw, n)
    skew_err, skew_rows = 0.0, []
    for f in (2, 6, 9, 32):
        x = torch.randn((n, f), generator=gen, device="cuda")
        got = ops.segment_spmm(x, sk, sw, n)
        want = ref.segment_spmm_csr_ref(x, *s_csr)
        torch.cuda.synchronize()
        err = check_close(f"segment_spmm skewed F={f}", got, want, TOL_SPMM)
        faults = spmm_faults(f"skewed F={f}", ops, x, *s_csr, want)
        skew_err = max(skew_err, err)
        row = {"F": f, "max_abs_err": err, "fault_over_limit": faults,
               "ms": timer(lambda x=x: ops.segment_spmm_csr(x, *s_csr)),
               "old_ms": timer(lambda x=x: old_csr(x, *s_csr))}
        skew_rows.append(row)
        log(f"[kernel] segment_spmm skewed F={f} ({m} lanes into one row, "
            f"half of them zero-weight pads): max|err| {err:.2e}, faults "
            f"rejected at x limit: zeros {faults['zeros']:.1f}, last edge "
            f"dropped {faults['last edge dropped']:.1f}; kernel "
            f"{row['ms']:.4f} ms, previous design {row['old_ms']:.4f}")
    return results, err_all, skew_err, skew_rows


def check_ttm(torch, n: int, window: int, timer):
    """Banded TTM at the serving shape (T = w = 5, NF = N * 6)."""
    from repro_torch.kernels.mproduct import ops, ref

    t = window
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((t, n * 6), generator=gen, device="cuda")
    main_off = NUM_WINDOWS - 1 - (window - 1)   # last window, prefix form
    err_all, rows = 0.0, []
    for off in (-4, 0, 37, main_off):
        got = ops.banded_ttm(x, window, off)
        want = ref.banded_ttm_ref(x, window, off)
        torch.cuda.synchronize()
        err = check_close(f"banded_ttm t_offset={off}", got, want, TOL_TTM)
        err_all = max(err_all, err)
        rows.append({"t_offset": off, "max_abs_err": err})
    # dense band as a yardstick: M (T x T) @ X (T x NF)
    m = torch.zeros((t, t), device="cuda")
    for r in range(t):
        g = r + main_off + 1
        for k in range(max(0, r - window + 1, -main_off), r + 1):
            m[r, k] = 1.0 / min(window, g)
    lib_err = float((m @ x - ref.banded_ttm_ref(x, window, main_off)
                     ).abs().max())
    b_ms, b_by = bound_ms(2 * x.nbytes, float(x.numel() * window))
    res = {
        "shape": list(x.shape), "t_offset": main_off,
        "ms": timer(lambda: ops.banded_ttm(x, window, main_off)),
        "wrapper_ms": timer(lambda: ops.banded_ttm(x, window, main_off),
                            host=True),
        "plain_ms": timer(lambda: ref.banded_ttm_ref(x, window, main_off)),
        "library_ms": timer(lambda: m @ x),
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err_all,
        "library_max_abs_err": lib_err, "offsets": rows}
    log(f"[kernel] banded_ttm {tuple(x.shape)}: kernel {res['ms']:.4f} ms,"
        f" wrapper (host + device) {res['wrapper_ms']:.4f}, plain "
        f"{res['plain_ms']:.4f}, dense band matmul "
        f"{res['library_ms']:.4f}, bound {b_ms:.4f} ({b_by}), max|err| "
        f"{err_all:.2e} over t_offset {[r['t_offset'] for r in rows]}")
    return res


# ------------------------------------------------------------ profile ------

def profile_step(torch, eng):
    """The state-advance step alone, on the last window's graph: steady
    time over a few repeats, then one step under ``torch.profiler`` for
    device time by kernel and the device's idle share of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import models as mdl
    from repro_torch.graph import segment
    from repro_torch.kernels.segment_spmm import ops as spmm_ops

    n = eng.model.num_nodes
    edges, mask = eng.applier.current
    frame = torch.stack([segment.in_degree(edges, n, mask),
                         segment.out_degree(edges, n, mask)], dim=1)

    def step():
        carries = [c.clone() for c in eng.carries]
        return eng._advance(eng.params, carries, frame, edges, mask, mask,
                            NUM_WINDOWS)

    # the previous path: no shared CSR (each layer's wrapper builds its own)
    # and the thread-per-row kernel
    old_csr, _ = previous_spmm(spmm_ops)
    no_shared = types.SimpleNamespace(build_csr=lambda *a: None)

    def previous_step():
        with patched(mdl, "spmm_ops", no_shared), \
                patched(spmm_ops, "segment_spmm_csr", old_csr):
            return step()

    check_close("state-advance step, previous path vs this one",
                previous_step()[0], step()[0], TOL_SCORES)
    walls = alternating_walls(torch, {"step": step,
                                      "previous": previous_step}, 7)
    log(f"[profile] state-advance step (warm, host clock + sync, median of "
        f"6, in turns): {walls['step']:.3f} ms; on the previous path (a CSR "
        f"build per layer, thread-per-row kernel) {walls['previous']:.3f} ms")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    # device activities only (kernels, copies, sets): one stream, so their
    # durations add up to the device's busy time without overlap
    by_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    busy = sum(sum(v) for v in by_name.values())
    if busy <= 0:
        raise SystemExit("profile: the trace holds no device time")
    log(f"[profile] one step under the profiler: wall {wall_us / 1e3:.2f} "
        f"ms, device busy {busy / 1e3:.2f} ms, idle share "
        f"{1 - busy / wall_us:.3f}, {sum(map(len, by_name.values()))} "
        f"device activities")
    for name, v in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]:
        log(f"[profile]   {sum(v) / 1e3:8.3f} ms  x{len(v):<3d} {name[:90]}")
    return {"steady_ms": walls["step"],
            "previous_steady_ms": walls["previous"],
            "wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / wall_us}


# ------------------------------------------------------- plain parity ------

def plain_parity(eng, events):
    """The whole run replayed on the CPU, where the kernel wrappers run
    their plain versions: the last window's embeddings and queries, card
    (kernels) against CPU (plain)."""
    import numpy as np

    rng = np.random.default_rng(2)
    n = eng.model.num_nodes
    ids = rng.integers(0, n, 64)
    pairs = rng.integers(0, n, (64, 2))
    got_n, got_l = eng.query_nodes(ids), eng.query_links(pairs)
    plain, _ = serve_run("cpu", eng.params, n, events,
                         eng.applier.max_edges, NUM_WINDOWS)
    z_err = float((eng.z.cpu() - plain.z).abs().max())
    err = max(np.abs(got_n - plain.query_nodes(ids)).max(),
              np.abs(got_l - plain.query_links(pairs)).max())
    if not (err <= TOL_SCORES and z_err <= TOL_SCORES):
        raise SystemExit(f"served state: card (kernels) vs CPU (plain) "
                         f"max |diff| z {z_err:.3e}, scores {err:.3e} > "
                         f"{TOL_SCORES}")
    log(f"[serve] {NUM_WINDOWS} windows replayed on the CPU (plain "
        f"versions): last-window z max |diff| {z_err:.2e}, queries max "
        f"|diff| {err:.2e} (tolerance {TOL_SCORES})")


def small_parity(torch):
    """Small graphs, all three models: card (kernels) vs CPU (plain),
    after every window."""
    import numpy as np

    from repro_torch.core import models as mdl
    from repro_torch.core.ctdg import synthetic_ctdg
    from repro_torch.serve import IngestSpec, ServeConfig, ServeEngine

    n, windows = 40, 12
    ev = synthetic_ctdg(n, 500, delete_frac=0.25, seed=1)
    spec = IngestSpec(num_windows=windows, block_size=4, max_edges=512,
                      time_range=(float(ev.time.min()),
                                  float(ev.time.max())))
    for model in ("tmgcn", "cdgcn", "evolvegcn"):
        cfg = mdl.DynGNNConfig(model=model, num_nodes=n, window=3)
        params = mdl.init_params(torch.Generator().manual_seed(7), cfg)
        gpu = ServeEngine(ServeConfig(model=cfg, ingest=spec),
                          params=params, device="cuda")
        cpu = ServeEngine(ServeConfig(model=cfg, ingest=spec),
                          params=params, device="cpu")
        gpu.ingest(ev)
        cpu.ingest(ev)
        err = 0.0
        for _ in range(windows):
            gpu.advance()
            cpu.advance()
            err = max(err, np.abs(gpu.query_nodes(np.arange(n))
                                  - cpu.query_nodes(np.arange(n))).max())
        if not err <= TOL_SCORES:
            raise SystemExit(f"small {model}: card vs CPU max |diff| "
                             f"{err:.3e} > {TOL_SCORES}")
        log(f"[parity] {model} N={n}: card (kernels) vs CPU (plain), "
            f"{windows} windows, max |diff| {err:.2e}")


# ------------------------------------------------------------- LM path -----

def lm_path(torch, kernels, obs):
    """Phase 5: Yi-6B at full width through ``ServeEngine.generate``."""
    import numpy as np

    from repro_torch.configs import yi_6b
    from repro_torch.kernels.build import reset_counts
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = yi_6b.make_config()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = ServeEngine(ServeConfig(model=cfg, batch_sizes=(LM_BATCH,),
                                  prompt_len=LM_PROMPT,
                                  max_tokens=LM_TOKENS), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(eng.params))
    log(f"[lm] {cfg.name}: {n_params:,} parameters ({cfg.dtype}) drawn on "
        f"the card in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if n_params != cfg.param_count():
        raise SystemExit(f"lm: {n_params} parameters, the config says "
                         f"{cfg.param_count()}")
    torch.cuda.reset_peak_memory_stats()
    tracer = obs.configure(enabled=True)     # fenced prefill/decode spans
    reset_counts(kernels)
    tokens = eng.generate()
    launches = {k.name: k.launches for k in kernels}
    obs.configure(enabled=False)
    steps = LM_TOKENS - 1
    check_launches("lm", launches, {"segment_spmm": 0, "banded_ttm": 0,
                                    "flash_decode": cfg.num_layers * steps})
    r = eng.result()
    if tokens.shape != (LM_BATCH, LM_TOKENS) or not (
            (tokens >= 0) & (tokens < cfg.padded_vocab)).all():
        raise SystemExit(f"lm: bad tokens {tokens.shape}, range "
                         f"[{tokens.min()}, {tokens.max()}]")
    spans = {}
    for sp in tracer.spans():
        spans.setdefault(sp.name, []).append(sp.dur_s * 1e3)
    prefill_ms = spans["serve.prefill"][0]
    decode_ms = spans["serve.decode"]
    if len(decode_ms) != steps:
        raise SystemExit(f"lm: {len(decode_ms)} decode spans, expected "
                         f"{steps}")
    wall = r.query_seconds
    stats = {
        "prefill_ms": prefill_ms,
        "decode_ms_p50": statistics.median(decode_ms),
        "decode_ms_p95": sorted(decode_ms)[int(0.95 * (steps - 1))],
        "decode_tokens_per_s": LM_BATCH * steps / (sum(decode_ms) / 1e3),
        "tokens_per_s": tokens.size / wall, "generate_s": wall,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches["flash_decode"]}
    log(f"[lm] generate: B={LM_BATCH}, prompt {LM_PROMPT}, {LM_TOKENS} "
        f"tokens, {wall:.3f} s -> {stats['tokens_per_s']:.1f} tokens/s "
        f"(fenced spans)")
    log(f"[lm] prefill {prefill_ms:.1f} ms; decode per step p50 "
        f"{stats['decode_ms_p50']:.3f} ms, p95 {stats['decode_ms_p95']:.3f}"
        f" ms over {steps} steps -> {stats['decode_tokens_per_s']:.1f} "
        f"decode tokens/s")
    log(f"[lm] peak device memory {stats['peak_gib']:.2f} GiB; tokens in "
        f"[0, {cfg.padded_vocab}): {tokens.shape}, first row "
        f"{np.asarray(tokens[0, :8]).tolist()}")
    return eng, stats


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def profile_decode(torch, eng):
    """One Yi-6B decode step at the path's shape: warm steady time, then
    one step under ``torch.profiler`` (device busy, idle share, top ops)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.models import lm
    from repro_torch.nn import attention

    cfg, params = eng.model, eng.params
    gen = torch.Generator(device="cuda").manual_seed(5)
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=gen, device="cuda")
    logits, cache = lm.prefill(cfg, params, prompts, LM_PROMPT + LM_TOKENS)
    tok = torch.argmax(logits, -1)

    def step():
        nonlocal cache, tok
        lg, cache = lm.decode_step(cfg, params, cache, tok)
        tok = torch.argmax(lg, -1)

    old_fd = previous_decode_attention(torch, fd_ops)

    def previous_step():
        with patched(attention, "decode_attention", old_fd):
            step()

    walls = alternating_walls(torch, {"step": step,
                                      "previous": previous_step}, 8, warm=2)
    steady = walls["step"]

    def profiled(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_name: dict[str, list[float]] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name.setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
        busy = sum(sum(v) for v in by_name.values())
        if busy <= 0:
            raise SystemExit("profile: the trace holds no device time")
        fd = sum(sum(v) for n, v in by_name.items() if "flash_decode" in n)
        return wall_us, busy, fd, by_name

    wall_us, busy, fd, by_name = profiled(step)
    _, old_busy, old_fd_us, _ = profiled(previous_step)
    weight_bytes = sum(t.nbytes for t in _leaves(params))
    # the K/V rows the profiled step reads, in bf16
    kv_bytes = 2 * cfg.num_layers * int(cache["len"].sum()) \
        * cfg.num_kv_heads * cfg.head_dim * 2
    bound = (weight_bytes + kv_bytes) / 3.35e12 * 1e3
    res = {"steady_ms": steady, "wall_ms": wall_us / 1e3,
           "busy_ms": busy / 1e3, "idle_share": 1 - busy / wall_us,
           "flash_decode_ms": fd / 1e3, "bound_ms": bound,
           "activities": sum(map(len, by_name.values())),
           "previous_steady_ms": walls["previous"],
           "previous_busy_ms": old_busy / 1e3,
           "previous_flash_decode_ms": old_fd_us / 1e3}
    log(f"[profile-lm] decode step (warm, host clock + sync, median of 6, "
        f"in turns): {steady:.3f} ms; with the previous flash_decode "
        f"{walls['previous']:.3f} ms; bound {bound:.3f} ms "
        f"({weight_bytes / 1e9:.2f} GB of weights + "
        f"{kv_bytes / 1e9:.2f} GB of K/V at 3.35 TB/s)")
    log(f"[profile-lm] one step under the profiler: wall "
        f"{res['wall_ms']:.3f} ms, device busy {res['busy_ms']:.3f} ms, "
        f"idle share {res['idle_share']:.3f}, {res['activities']} device "
        f"activities, flash_decode {res['flash_decode_ms']:.3f} ms; with "
        f"the previous flash_decode: device busy "
        f"{res['previous_busy_ms']:.3f} ms, flash_decode "
        f"{res['previous_flash_decode_ms']:.3f} ms")
    for name, v in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]:
        log(f"[profile-lm]   {sum(v) / 1e3:8.3f} ms  x{len(v):<4d} "
            f"{name[:90]}")
    return res


def fd_excess(dtype: str, got, want32) -> tuple[float, float]:
    """-> (max |kernel - plain fp32|, the largest ratio of a batch row's
    max |diff| to that row's limit; the check passes at <= 1).  A row's
    limit is, in f32, TOL_FD abs + rel x the row's max |plain|; in bf16,
    TOL_FD x the row's max |plain|, scaled to the output alone: the output
    shrinks as 1 / sqrt(cache rows), so a fixed absolute term, or one
    scaled to another row's larger output, would pass zeros."""
    diff = (got - want32).abs().flatten(1).amax(1)
    peak = want32.abs().flatten(1).amax(1)
    limit = TOL_FD[dtype] * (peak if dtype == "bfloat16" else 1.0 + peak)
    return float(diff.max()), float((diff / limit).max())


def dropped_split_lens(lens: list[int], s: int, splits: int) -> list[int]:
    """``cache_len`` with one split's share of each sequence's rows taken
    off its end (at least one row kept; rows with ``cache_len <= 0`` keep
    their meaning): the kernel run on these is the kernel with a split
    dropped."""
    out = []
    for x in lens:
        n = min(x, s)
        out.append(x if x <= 0 else max(n - -(-n // splits), 1))
    return out


def previous_decode_attention(torch, ops):
    """The previous design of ``decode_attention``, for timing beside the
    kernel: its wrapper's host path as it was (every check on every call,
    three allocations, the device switch) and its partial kernel on CUDA
    cores (head tile 8 for G > 1; still in ``csrc/flash_decode.cu``, which
    f32 runs), not counted."""

    def call(q, k, v, cache_len):
        b, hq, d = q.shape
        s, kvh = k.shape[1], k.shape[2]
        if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
            raise ValueError("flash_decode: bad shapes")
        if k.shape[0] != b or k.shape[3] != d or s < 1 or hq % kvh != 0:
            raise ValueError("flash_decode: k does not fit q")
        if d % 8 != 0 or d > 256:
            raise ValueError("flash_decode: bad D")
        for t, dt in ((q, q.dtype), (k, q.dtype), (v, q.dtype),
                      (cache_len, torch.int32)):
            if t.device != q.device or t.dtype != dt or \
                    not t.is_contiguous():
                raise ValueError("flash_decode: bad tensor")
            if t.data_ptr() % 16:
                raise ValueError("flash_decode: misaligned")
        if cache_len.shape != (b,):
            raise ValueError("flash_decode: bad cache_len")
        g = hq // kvh
        tile = 1 if g == 1 else 8
        splits = max(1, min(2 * ops._sm_count(q.device.index or 0)
                            // (b * kvh * -(-g // tile)),
                            -(-s // ops.MIN_ROWS_PER_SPLIT)))
        part_ml = torch.empty((b, hq, splits, 2), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((b, hq, splits, d), dtype=torch.float32,
                               device=q.device)
        out = torch.empty_like(q)
        with torch.cuda.device(q.device):
            ops.KERNEL.launch_uncounted(
                ops.KERNEL.symbol, q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), cache_len.data_ptr(), part_ml.data_ptr(),
                part_acc.data_ptr(), out.data_ptr(), b, s, hq, kvh, d, tile,
                splits, int(q.dtype == torch.bfloat16))
        return out

    return call


def check_flash_decode(torch, timer):
    """Phase 6: the kernel against its plain version, and timed.  Each
    case also shows that its check rejects two faulty outputs made on the
    card: zeros, and the kernel's own output with one split's rows
    dropped."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import ops, ref

    s_path = LM_PROMPT + LM_TOKENS
    cases = [  # name, B, Hq, KVH, D, S, cache_len
        ("path", 8, 32, 4, 128, s_path, [LM_PROMPT + 32] * 8),
        ("path ragged", 8, 32, 4, 128, s_path,
         [1, s_path, 4097, 2000, 3000, 17, 4100, 9999]),
        ("decode_32k", 8, 32, 4, 128, 32768,
         [32768, 1, 30000, 16384, 32767, 5000, 20000, 32768]),
        ("long_500k", 1, 32, 4, 128, 524288, [524288]),
        ("D64 G1", 8, 36, 36, 64, s_path, [LM_PROMPT + 32] * 8),
        ("D256 G1", 8, 16, 16, 256, s_path, [LM_PROMPT + 32] * 8),
        ("G2", 2, 8, 4, 128, 300, [300, 123]),
        ("cache_len 0", 2, 32, 4, 128, s_path, [0, s_path]),
        ("D64 G4", 2, 16, 4, 64, 1000, [1000, 77]),
    ]
    old_fd = previous_decode_attention(torch, ops)
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, err_all = [], 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for name, b, hq, kvh, d, s, lens in cases:
            q = torch.randn((b, hq, d), generator=gen, device="cuda"
                            ).to(dtype)
            k = torch.randn((b, s, kvh, d), generator=gen, device="cuda"
                            ).to(dtype)
            v = torch.randn((b, s, kvh, d), generator=gen, device="cuda"
                            ).to(dtype)
            cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got = ops.decode_attention(q, k, v, cl).float()
            want = ref.flash_decode_ref(q, k, v, cl)
            # the plain version's fp32 result before its cast to q's type
            want32 = want if dtype == torch.float32 else \
                ref.flash_decode_ref(q.float(), k.float(), v.float(), cl)
            torch.cuda.synchronize()
            err, ratio = fd_excess(dname, got, want32)
            if not ratio <= 1.0:
                raise SystemExit(f"flash_decode {name} {dname}: kernel "
                                 f"disagrees with its plain version: max "
                                 f"|diff| {err:.3e}, {ratio:.3f} x a row's "
                                 "limit")
            err_all = max(err_all, err)
            old_got = old_fd(q, k, v, cl).float()
            torch.cuda.synchronize()
            old_err, old_ratio = fd_excess(dname, old_got, want32)
            if not old_ratio <= 1.0:
                raise SystemExit(f"flash_decode {name} {dname}: the previous "
                                 f"design disagrees ({old_ratio:.3f} x a "
                                 "row's limit)")
            pl = ops.plan(b, s, hq, kvh, d, dtype == torch.bfloat16,
                          ops._sm_count(0))
            instance = "tensor cores" if pl[0] == ops.TC_HEADS \
                else "CUDA cores"
            cut = torch.tensor(dropped_split_lens(lens, s, pl[1]),
                               dtype=torch.int32, device="cuda")
            faults = {
                "zeros": fd_excess(dname, torch.zeros_like(got), want32)[1],
                "a split dropped": fd_excess(dname, ops.decode_attention(
                    q, k, v, cut).float(), want32)[1]}
            for fault, fratio in faults.items():
                if fratio <= 1.0:
                    raise SystemExit(
                        f"flash_decode {name} {dname}: the check would "
                        f"pass a kernel that wrote {fault} ({fratio:.3f} x "
                        "a row's limit)")
            # the yardstick: SDPA over (B, KVH, S, D) views with a length
            # mask (all-masked rows give NaN there, so its error is taken
            # over rows with cache_len >= 1)
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            n_rows = [min(x, s) if x > 0 else s for x in lens]
            mask = (torch.arange(s, device="cuda")[None, :]
                    < torch.tensor(n_rows, device="cuda")[:, None]
                    )[:, None, None, :]

            def lib(q=q, kt=kt, vt=vt, mask=mask):
                return F.scaled_dot_product_attention(
                    q[:, :, None, :], kt, vt, attn_mask=mask,
                    enable_gqa=True)[:, :, 0]

            ok = torch.tensor([x > 0 for x in lens], device="cuda")
            lib_err = float((lib() - want).float()[ok].abs().max())
            esize = q.element_size()
            nbytes = 2 * q.nbytes + cl.nbytes \
                + 2 * sum(n_rows) * kvh * d * esize
            b_ms, b_by = bound_ms(nbytes, 4.0 * sum(n_rows) * hq * d)

            def kern(q=q, k=k, v=v, cl=cl):
                return ops.decode_attention(q, k, v, cl)

            def old(q=q, k=k, v=v, cl=cl):
                return old_fd(q, k, v, cl)

            row = {
                "case": name, "dtype": dname,
                "B": b, "Hq": hq, "KVH": kvh, "D": d, "S": s,
                "cache_len": lens, "instance": instance,
                "ms": timer(kern), "wrapper_ms": timer(kern, host=True),
                "old_ms": timer(old), "old_wrapper_ms": timer(old,
                                                              host=True),
                "plain_ms": timer(lambda q=q, k=k, v=v, cl=cl:
                                  ref.flash_decode_ref(q, k, v, cl)),
                "library_ms": timer(lib),
                "ms_write_flush": timer(kern, flush="write"),
                "old_ms_write_flush": timer(old, flush="write"),
                "library_ms_write_flush": timer(lib, flush="write"),
                "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                "err_over_limit": ratio,
                "max_abs_err_vs_plain_in_dtype": float(
                    (got - want.float()).abs().max()),
                "fault_over_limit": faults, "library_max_abs_err": lib_err,
                "old_err_over_limit": old_ratio, "plan": pl}
            log(f"[kernel] flash_decode {name} {dname} (B {b}, Hq {hq}, "
                f"KVH {kvh}, D {d}, S {s}, plan {row['plan']}, {instance})"
                f": kernel {row['ms']:.4f} ms (wrapper, host + device "
                f"{row['wrapper_ms']:.4f}), previous design "
                f"{row['old_ms']:.4f}"
                f" (wrapper {row['old_wrapper_ms']:.4f}), plain "
                f"{row['plain_ms']:.4f}, sdpa {row['library_ms']:.4f}, bound "
                f"{b_ms:.4f} ({b_by}); with a write flush: kernel "
                f"{row['ms_write_flush']:.4f}, previous design "
                f"{row['old_ms_write_flush']:.4f}, sdpa "
                f"{row['library_ms_write_flush']:.4f}")
            log(f"[kernel]   max|err| {err:.3e}, {ratio:.3f} x a row's "
                f"limit (previous design {old_ratio:.3f}); faults rejected at "
                "x limit: zeros "
                f"{faults['zeros']:.1f}, a split dropped "
                f"{faults['a split dropped']:.1f}; sdpa max|err| "
                f"{lib_err:.2e}")
            rows.append(row)
            del q, k, v, got, want, want32, kt, vt, lib, kern, old, old_got
    return rows, err_all


def lm_parity(torch):
    """Phase 7: Yi-6B's full widths at 2 layers in f32, the card's kernel
    path against the CPU's plain path on the same parameters."""
    import dataclasses

    from repro_torch.configs import yi_6b
    from repro_torch.models import lm
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = dataclasses.replace(yi_6b.make_config(), num_layers=2,
                              dtype=torch.float32)
    sc = ServeConfig(model=cfg, batch_sizes=(2,), prompt_len=256,
                     max_tokens=8)
    gpu = ServeEngine(sc, device="cuda")
    cpu = ServeEngine(sc, params=gpu.params, device="cpu")
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (2, 256 + 8), generator=gen)
    max_len = 256 + 8
    glog, gcache = lm.prefill(cfg, gpu.params, toks[:, :256].cuda(),
                              max_len)
    clog, ccache = lm.prefill(cfg, cpu.params, toks[:, :256], max_len)
    errs = [check_close("lm prefill logits", glog.cpu(), clog, TOL_LOGITS)]
    for t in range(256, 256 + 8):
        glog, gcache = lm.decode_step(cfg, gpu.params, gcache,
                                      toks[:, t].cuda())
        clog, ccache = lm.decode_step(cfg, cpu.params, ccache, toks[:, t])
        errs.append(check_close(f"lm decode step {t - 255} logits",
                                glog.cpu(), clog, TOL_LOGITS))
    limit = TOL_LOGITS * (1.0 + float(clog.abs().max()))
    log(f"[parity-lm] yi-6b widths, 2 layers, f32, B 2, prompt 256: card "
        f"(kernel) vs CPU (plain) logits max |diff| prefill {errs[0]:.2e},"
        f" decode steps {max(errs[1:]):.2e} (limit ~{limit:.2e})")


# ---------------------------------------------------------------- main -----

def main() -> int:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run it from the root of a checkout (no "
              "src/repro_torch here)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels as kmod
    from repro_torch import obs
    from repro_torch.configs.paper_dyngnn import DATASETS
    from repro_torch.kernels.build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    kernels = list(kmod.ALL)
    t0 = time.perf_counter()
    logs = build_all(kernels)
    log(f"[build] {len(kernels)} kernels built in "
        f"{time.perf_counter() - t0:.1f} s (nvcc, sm_90a, in parallel)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
        return out

    n_nodes, _, max_edges = DATASETS["epinions"]
    eng, events, launches = phase("main path", main_path, torch, kernels,
                                  obs, n_nodes, max_edges)
    timer = Timer(torch)
    spmm_rows, spmm_err, skew_err, skew_rows = phase(
        "segment_spmm check", check_spmm, torch, eng, timer)
    ttm = phase("banded_ttm check", check_ttm, torch, n_nodes,
                eng.model.window, timer)
    step_prof = phase("profile", profile_step, torch, eng)
    phase("plain-path parity", plain_parity, eng, events)
    phase("small-graph parity", small_parity, torch)
    del eng, events
    lm_eng, lm_stats = phase("lm path", lm_path, torch, kernels, obs)
    lm_prof = phase("lm profile", profile_decode, torch, lm_eng)
    del lm_eng
    torch.cuda.empty_cache()
    fd_rows, fd_err = phase("flash_decode check", check_flash_decode, torch,
                            timer)
    phase("lm parity", lm_parity, torch)

    spmm_main = next(r for r in spmm_rows if r["F"] == 6)  # layer 2
    report = {"kernels": [
        {"name": "segment_spmm", "route": "cuda",
         "source": "src/repro_torch/csrc/segment_spmm.cu",
         "replaces": "src/repro/kernels/segment_spmm/segment_spmm.py:55",
         "launches": launches["segment_spmm"], "max_abs_err": spmm_err,
         "ms": spmm_main["ms"], "plain_ms": spmm_main["plain_ms"],
         "bound_ms": spmm_main["bound_ms"],
         "bound_by": spmm_main["bound_by"],
         "library_ms": spmm_main["library_ms"], "shapes": spmm_rows,
         "skewed_max_abs_err": skew_err, "skewed": skew_rows,
         "csr_builds": launches["csr_builds"],
         "state_advance": step_prof},
        {"name": "banded_ttm", "route": "cuda",
         "source": "src/repro_torch/csrc/banded_ttm.cu",
         "replaces": "src/repro/kernels/mproduct/mproduct.py:54",
         "launches": launches["banded_ttm"],
         "max_abs_err": ttm["max_abs_err"], "ms": ttm["ms"],
         "plain_ms": ttm["plain_ms"], "bound_ms": ttm["bound_ms"],
         "bound_by": ttm["bound_by"], "library_ms": ttm["library_ms"],
         "detail": ttm},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode/flash_decode.py:69",
         "launches": lm_stats["launches"], "max_abs_err": fd_err,
         "ms": fd_rows[0]["ms"], "plain_ms": fd_rows[0]["plain_ms"],
         "bound_ms": fd_rows[0]["bound_ms"],
         "bound_by": fd_rows[0]["bound_by"],
         "library_ms": fd_rows[0]["library_ms"], "shapes": fd_rows,
         "lm_path": lm_stats, "decode_profile": lm_prof}]}
    log("[done] kernels launched on the main path and checked against "
        "their plain versions: " + ", ".join(k.name for k in kernels))
    log(json.dumps(report))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
