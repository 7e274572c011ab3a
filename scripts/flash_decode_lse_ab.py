"""Time ``flash_decode`` before and after its log-sum-exp output, in turns.

    python3 scripts/flash_decode_lse_ab.py PARENT_FLASH_DECODE_CU [REPS]

Needs one CUDA card and ``nvcc``.  Builds PARENT_FLASH_DECODE_CU (the
kernel source as it was before ``lse`` joined its C interface: seven
pointers, no ``lse``) and ``src/repro_torch/csrc/flash_decode.cu`` with
the repository's nvcc flags, then at each shape of ``CASES`` times three
calls on the same inputs, in turns, each behind a device sleep with L2
flushed (CUDA events, median of REPS, default 30): the parent's kernel,
this source's without ``lse``, and this source's with it (the order
reversed every other round).  The plan
(instance and splits) is ``kernels.flash_decode.ops.plan``'s for both.
Prints the card's name and power limit, one line a shape, and one JSON
line of the medians.
"""

import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_decode import ops  # noqa: E402

#: name, dtype, B, Hq, KVH, D, S, cache_len: the bold and long rows of
#: PERF.md's kernel table and a long_500k rank's slice
CASES = [
    ("path", torch.bfloat16, 8, 32, 4, 128, 4160, [4128] * 8),
    ("long_500k", torch.bfloat16, 1, 32, 4, 128, 524288, [524288]),
    ("OLMoE long_500k", torch.bfloat16, 1, 16, 16, 128, 524288, [524288]),
    ("OLMoE f32", torch.float32, 8, 16, 16, 128, 4160, [4160] * 8),
    ("long_500k slice", torch.bfloat16, 1, 32, 4, 128, 131072, [131072]),
]


def _load(source: Path, out: Path, n_ptr: int):
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(source)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).flash_decode
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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


def main() -> int:
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as d:
        parent = _load(Path(sys.argv[1]), Path(d) / "parent.so", 7)
        this = _load(ROOT / "src/repro_torch/csrc/flash_decode.cu",
                     Path(d) / "this.so", 8)
        flush = torch.ones(16 << 20, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(3)
        rows = []
        for name, dtype, b, hq, kvh, d_, s, lens in CASES:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for shape in
                       ((b, hq, d_), (b, s, kvh, d_), (b, s, kvh, d_)))
            cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
            tile, splits = ops.plan(b, s, hq, kvh, d_,
                                    dtype == torch.bfloat16,
                                    ops._sm_count(0))
            scratch = torch.empty(b * hq * splits * (2 + d_),
                                  device="cuda")
            out = torch.empty_like(q)
            lse = torch.empty((b, hq), device="cuda")
            ml = scratch.data_ptr()
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    cl.data_ptr(), ml, ml + 8 * b * hq * splits)
            ints = (b, s, hq, kvh, d_, tile, splits,
                    int(dtype == torch.bfloat16))
            stream = torch.cuda.current_stream().cuda_stream
            calls = {
                "parent": lambda: parent(*ptrs, out.data_ptr(), *ints,
                                         stream),
                "without_lse": lambda: this(*ptrs, out.data_ptr(), None,
                                            *ints, stream),
                "with_lse": lambda: this(*ptrs, out.data_ptr(),
                                         lse.data_ptr(), *ints, stream)}
            times = {k: [] for k in calls}
            for fn in calls.values():
                if fn() != 0:
                    raise SystemExit(f"{name}: launch failed")
            for r in range(reps):           # A B C, C B A, ...
                keys = list(calls) if r % 2 == 0 else list(calls)[::-1]
                for key in keys:
                    times[key].append(_timed(calls[key], flush))
            med = {k: statistics.median(v) for k, v in times.items()}
            rows.append({"case": name, "dtype": str(dtype).split(".")[-1],
                         "B": b, "Hq": hq, "KVH": kvh, "D": d_, "S": s,
                         **{f"{k}_ms": v for k, v in med.items()}})
            print(f"{name} {rows[-1]['dtype']}: parent {med['parent']:.4f} "
                  f"ms, without lse {med['without_lse']:.4f}, with lse "
                  f"{med['with_lse']:.4f}")
    print(json.dumps({"flash_decode_lse_ab": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
