"""Time ``flash_decode``'s bf16 tensor-core instance against its variants,
an earlier source and SDPA, in turns, at G = 1 and G > 1.

    python3 scripts/flash_decode_g1_ab.py [--variants tc,s3,s4-clock]
        [--cases WORDS] [--parent PARENT_CU] [--reps N] [--out FILE.json]

To time the design that bf16 G = 1 ran on before (the CUDA-core
instance), unpack the parent commit's ``flash_decode.cu`` and pass it as
``--parent``::

    git show HEAD~1:src/repro_torch/csrc/flash_decode.cu > parent.cu

Needs one CUDA card and ``nvcc``.  Builds ``src/repro_torch/csrc/
flash_decode.cu`` with the repository's nvcc flags once for each source
variant that ``--variants`` names (one nvcc each, all at once):

- ``tc``: the source as committed (its ring at each padded D as
  ``ops.TC_RING`` says);
- ``sN``: a ring of N stages at every D, as many CTAs an SM as its
  shared memory holds (at most 4);
- modifiers after either: ``-nopdl`` launches the combine after the
  partial kernel ends (not as a programmatic dependent); ``-stream`` cuts
  the loop down to the ring (the tiles waited for, nothing computed: the
  ring's streaming rate); ``-clock`` makes each partial CTA write its
  start and end on the card's global timer in place of its (m, l) and
  prints their spread (these two give no output to check).

At each shape of ``CASES`` (bf16; ``--cases`` keeps the names that
contain one of its comma-separated words) it checks each build against
the plain version's fp32 result (1e-2 x each batch row's max, as
``chip_smoke.py`` holds bf16), then times in turns, each call behind a
device sleep with L2 flushed (CUDA events, median of N, default 20):
each variant at its plan; ``parent``, an earlier copy of the source
with the same C interface at its own plan (tensor cores for G > 1 at
D <= 128, the CUDA-core instance otherwise: group_tile 1 at G = 1, else
8, at the f32 plan's splits), with ``--parent``; ``sdpa``,
``scaled_dot_product_attention`` over (B, KVH, S, D) views with a length
mask; ``sum``, ``k.sum()`` and ``v.sum()`` (PyTorch's reduction reading
the cache once).  One call of SDPA and of the first variant is profiled
(kernel names, grids, device us).  Prints the card's name and power
limit, the builds' register and spill lines, one line a shape, and one
JSON line of everything (also written to ``--out``).
"""

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_decode import ops, ref  # noqa: E402

SOURCE = ROOT / "src/repro_torch/csrc/flash_decode.cu"
#: name, B, Hq, KVH, D, S, cache_len, with the log-sum-exp output
CASES = [
    ("OLMoE", 8, 16, 16, 128, 4160, [4160] * 8, False),
    ("OLMoE ragged", 8, 16, 16, 128, 4160,
     [1, 4160, 4097, 2000, 3000, 17, 4100, 9999], False),
    ("OLMoE cache_len 0", 2, 16, 16, 128, 4160, [0, 4160], False),
    ("OLMoE long_500k", 1, 16, 16, 128, 524288, [524288], False),
    ("OLMoE long_500k slice, lse", 1, 16, 16, 128, 131072, [131072], True),
    ("MiniCPM", 8, 36, 36, 64, 4160, [4160] * 8, False),
    ("Gemma", 8, 16, 16, 256, 4160, [4160] * 8, False),
    ("Yi path", 8, 32, 4, 128, 4160, [4128] * 8, False),
    ("Yi long_500k", 1, 32, 4, 128, 524288, [524288], False),
    ("D64 G4", 2, 16, 4, 64, 1000, [1000, 77], False),
    ("D256 G4", 2, 16, 4, 256, 4160, [4160, 999], False),
]
TOL_BF16 = 1e-2
SMEM_MAX = 232_448              # dynamic shared memory a CTA may have
SMEM_SM = 233_472               # an SM's, 1 KB of it kept for each CTA
MODS = {"nopdl", "stream", "clock"}


def _sub(src: str, old: str, new: str) -> str:
    assert src.count(old) == 1, old
    return src.replace(old, new)


def variant_source(src: str, stages: int | None, mods: set) -> str:
    """The committed source with a variant's changes (see the module
    docstring)."""
    if stages is not None:
        src = re.sub(r"(constexpr int tc_stages\(int dt\) \{\n  return )"
                     r"[^;]*;", rf"\g<1>{stages};", src)
        # as many CTAs as fit: defined after tc_smem_bytes, which it reads
        fit = re.search(r"__host__ __device__ constexpr int tc_ctas_per_sm"
                        r"\(int dt\) \{\n  return [^;]*;\n\}\n", src)
        src = src[:fit.start()] + src[fit.end():]
        anchor = re.search(r"__host__ __device__ constexpr size_t "
                           r"tc_smem_bytes\(int dt\) \{\n(.*\n)*?\}\n", src)
        src = (src[:anchor.end()]
               + "__host__ __device__ constexpr int tc_ctas_per_sm(int dt) "
               f"{{\n  const int n = {SMEM_SM} / (static_cast<int>("
               "tc_smem_bytes(dt)) + 1024);\n"
               "  return n < 1 ? 1 : n > 4 ? 4 : n;\n}\n"
               + src[anchor.end():])
    if "nopdl" in mods:
        src = _sub(src, "programmaticStreamSerializationAllowed = 1;",
                   "programmaticStreamSerializationAllowed = 0;")
    kernel = src.index("flash_decode_partial_tc(")
    if "clock" in mods:
        a = src.index("  const int lane = threadIdx.x & 31;\n", kernel)
        src = (src[:a] + '  unsigned clk0;\n  asm volatile("mov.u32 %0, '
               '%%globaltimer_lo;" : "=r"(clk0));\n' + src[a:])
        old = ("      part_ml[row * 2] = mx;\n"
               "      part_ml[row * 2 + 1] = sum_l;\n")
        a = src.rindex(old)
        src = (src[:a] + '      unsigned clk1;\n      asm volatile("mov.u32 '
               '%0, %%globaltimer_lo;" : "=r"(clk1));\n      part_ml[row * 2]'
               ' = __uint_as_float(clk0);\n      part_ml[row * 2 + 1] = '
               '__uint_as_float(clk1);\n' + src[a + len(old):])
    if "stream" in mods:
        a = src.index("    // S (16 heads x 16 rows) = Q K^T")
        b = src.index("\n  }\n", a)        # the tile loop's end
        src = src[:a] + src[b:]
    return src


def variant_ring(stages: int | None) -> dict:
    """-> ``ops.TC_RING`` for the variant."""
    if stages is None:
        return dict(ops.TC_RING)
    ring = {}
    for dt in (64, 128, 256):
        saved, ops.TC_RING = ops.TC_RING, {dt: (stages, 1)}
        try:
            smem = ops.tc_smem_bytes(dt)
        finally:
            ops.TC_RING = saved
        ring[dt] = (stages, max(1, min(4, SMEM_SM // (smem + 1024))))
    return ring


def _plan(b, s, hq, kvh, d, ring):
    """ops.plan and tc_smem_bytes with a variant's ring."""
    saved, ops.TC_RING = ops.TC_RING, ring
    try:
        return ops.plan(b, s, hq, kvh, d, True, ops._sm_count(0)), \
            ops.tc_smem_bytes(d)
    finally:
        ops.TC_RING = saved


def _start(source_text: str, out: Path) -> tuple:
    """Start nvcc on ``source_text`` -> (out, process)."""
    src = out.with_suffix(".cu")
    src.write_text(source_text)
    return out, subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(started: tuple) -> tuple:
    """Wait for a build and bind its launcher -> (fn, ptxas lines)."""
    out, proc = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {out.name}:\n{log}")
    fn = ctypes.CDLL(str(out)).flash_decode
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lines = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    return fn, lines


def _timed(fn, flush: torch.Tensor) -> float:
    """One call's device ms, behind a device sleep, L2 flushed."""
    flush.sum()
    torch.cuda._sleep(1_000_000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def _profile(fn) -> list:
    """One call of ``fn`` under the profiler -> [(kernel, grid, us)]."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        events = json.loads(Path(f.name).read_text())["traceEvents"]
    return [(e["name"], e.get("args", {}).get("grid"), e.get("dur", 0.0))
            for e in events if e.get("cat") == "kernel"]


def _clock_spread(scratch, b, hq, kvh, splits) -> dict:
    """The ``-clock`` build's per-CTA start and end (ns, low 32 bits of
    the global timer) -> their spread in us."""
    ml = scratch[:2 * b * hq * splits].view(torch.int32)
    ml = ml.view(b, hq, splits, 2)[:, ::hq // kvh]
    t = ml.reshape(-1, 2).to(torch.int64).cpu() & 0xFFFFFFFF
    t0, t1 = t[:, 0], t[:, 1]
    base = int(t0.min())
    span = float(t1.max() - base) / 1e3
    ends = (t1 - base).float() / 1e3
    return {"span_us": span, "ctas": len(t0),
            "busy_share": float((t1 - t0).sum()) / 1e3 / (len(t0) * span),
            "first_end_us": float(ends.min()),
            "median_end_us": float(ends.median()),
            "last_start_us": float((t0 - base).max()) / 1e3}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="tc")
    ap.add_argument("--cases", default="")
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    text = SOURCE.read_text()
    # variant -> ((stages, modifiers), ring)
    variants = {}
    for name in args.variants.split(","):
        m = re.fullmatch(r"(tc|s(\d+))((?:-[a-z0-9]+)*)", name)
        mods = set(m[3].split("-")[1:]) if m else {"?"}
        if not m or not mods <= MODS:
            raise SystemExit(f"bad variant {name}")
        stages = int(m[2]) if m[2] else None
        variants[name] = ((stages, mods), variant_ring(stages))
    report = {"card": card, "builds": {}, "cases": []}
    with tempfile.TemporaryDirectory() as tmp:
        started = {}
        for key, ((stages, mods), _) in variants.items():
            started[key] = _start(variant_source(text, stages, mods),
                                  Path(tmp) / f"{key}.so")
        if args.parent:
            started["parent"] = _start(args.parent.read_text(),
                                       Path(tmp) / "parent.so")
        builds = {}
        for key, st in started.items():
            builds[key], lines = _finish(st)
            report["builds"][key] = lines
            for ln in lines:
                if "Compiling" not in ln:
                    print(f"[build {key}] {ln}")
        parent = builds.pop("parent", None)
        flush = torch.ones(16 << 20, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(3)
        stream = torch.cuda.current_stream().cuda_stream
        words = [w for w in args.cases.split(",") if w]
        for name, b, hq, kvh, d, s, lens, with_lse in CASES:
            if words and not any(w in name for w in words):
                continue
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(torch.bfloat16) for shape in
                       ((b, hq, d), (b, s, kvh, d), (b, s, kvh, d)))
            cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
            want = ref.flash_decode_ref(q.float(), k.float(), v.float(), cl,
                                        with_lse)
            want = want[0] if with_lse else want
            limit = TOL_BF16 * want.abs().flatten(1).amax(1)
            n_rows = [min(x, s) if x > 0 else (0 if with_lse else s)
                      for x in lens]
            bound = (2 * q.nbytes + cl.nbytes
                     + 2 * sum(n_rows) * kvh * d * 2) / 3.35e12 * 1e3
            scratch = {}

            def call(fn, tile, splits, key, q=q, k=k, v=v, cl=cl, b=b, s=s,
                     hq=hq, kvh=kvh, d=d, with_lse=with_lse,
                     scratch=scratch):
                part = torch.empty(b * hq * splits * (2 + d), device="cuda")
                out = torch.empty_like(q)
                lse = torch.empty((b, hq), device="cuda") if with_lse \
                    else None
                ml = part.data_ptr()
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        cl.data_ptr(), ml, ml + 8 * b * hq * splits,
                        out.data_ptr(),
                        lse.data_ptr() if with_lse else None, b, s, hq,
                        kvh, d, tile, splits, 1, stream)
                if rc != 0:
                    raise SystemExit(f"{name} {key}: launch failed ({rc})")
                scratch[key] = part
                return out

            calls, plans = {}, {}
            for key, (_, ring) in variants.items():
                (tile, splits), smem = _plan(b, s, hq, kvh, d, ring)
                if smem > SMEM_MAX:
                    continue
                plans[key] = (tile, splits)
                calls[key] = (lambda fn=builds[key], tile=tile,
                              splits=splits, key=key:
                              call(fn, tile, splits, key))
            if parent is not None:
                old = ops.plan(b, s, hq, kvh, d, False, ops._sm_count(0))
                pp = (16, old[1]) if hq > kvh and d <= 128 else old
                plans["parent"] = pp
                calls["parent"] = lambda pp=pp: call(parent, *pp, "parent")
            errs, clocks = {}, {}
            for key, fn in calls.items():
                got = fn().float()
                torch.cuda.synchronize()
                if "-clock" in key:
                    clocks[key] = _clock_spread(scratch[key], b, hq, kvh,
                                                plans[key][1])
                    print(f"[clock {name} {key}] {clocks[key]}")
                if "-clock" in key or "-stream" in key:
                    continue
                rows_ok = [i for i, x in enumerate(lens)
                           if x > 0 or not with_lse]
                diff = (got - want).abs().flatten(1).amax(1)
                errs[key] = float((diff[rows_ok] / limit[rows_ok]).max())
                if not errs[key] <= 1.0:
                    raise SystemExit(f"{name} {key}: {errs[key]:.3f} x "
                                     "the bf16 limit")
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            mask = (torch.arange(s, device="cuda")[None, :]
                    < torch.tensor([x if x > 0 else s for x in n_rows],
                                   device="cuda")[:, None]
                    )[:, None, None, :]
            calls["sdpa"] = lambda q=q, kt=kt, vt=vt, mask=mask: \
                F.scaled_dot_product_attention(
                    q[:, :, None, :], kt, vt, attn_mask=mask,
                    enable_gqa=True)
            calls["sum"] = lambda k=k, v=v: (k.sum(), v.sum())
            for fn in calls.values():
                for _ in range(3):
                    fn()
            profiled = {}
            for key in ("sdpa", next(iter(calls))):
                profiled[key] = _profile(calls[key])
                for kname, grid, us in profiled[key]:
                    print(f"[{key} {name}] {us:.1f} us grid {grid} "
                          f"{kname[:100]}")
            times = {key: [] for key in calls}
            for r in range(args.reps):
                keys = list(calls) if r % 2 == 0 else list(calls)[::-1]
                for key in keys:
                    times[key].append(_timed(calls[key], flush))
            med = {key: statistics.median(t) for key, t in times.items()}
            report["cases"].append({
                "case": name, "B": b, "Hq": hq, "KVH": kvh, "D": d, "S": s,
                "cache_len": lens, "lse": with_lse, "bound_ms": bound,
                "plans": plans, "err_over_limit": errs, "clocks": clocks,
                "profiled": profiled,
                **{f"{key}_ms": t for key, t in med.items()}})
            print(f"{name} (B {b}, Hq {hq}, KVH {kvh}, D {d}, S {s}): "
                  + ", ".join(f"{key} {t:.4f}"
                              + (f" {plans[key]}" if key in plans else "")
                              for key, t in med.items())
                  + f" ms; bound {bound:.4f}")
            del q, k, v, want, kt, vt, calls, scratch
            torch.cuda.empty_cache()
    line = json.dumps({"flash_decode_g1_ab": report})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
