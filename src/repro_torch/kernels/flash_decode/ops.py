"""``decode_attention``: one new token's GQA attention on the split-KV
CUDA kernel.

Port of ``repro.kernels.flash_decode.ops.decode_attention`` (TPU kernel
``flash_decode``).  The kernel is ``csrc/flash_decode.cu``: a partial
kernel over (splits, KV heads x head groups, B) that streams each split's
K/V rows once for all the query heads sharing them, then a combine kernel
that merges the splits.  The wrapper picks the head-group tile and the
split count and allocates the fp32 scratch of the partials.  Any S is
taken; ``cache_len`` above S is clamped to S and ``cache_len <= 0`` gives
the uniform mean of V, as the reference's -1e30 mask does.

On a CPU tensor the wrapper runs the plain PyTorch version (``ref.py``);
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import Kernel
from repro_torch.kernels.flash_decode.ref import flash_decode_ref

KERNEL = Kernel("flash_decode", "flash_decode.cu", "flash_decode",
                [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8)

#: fewest cache rows a split gets, so a short cache is not cut into
#: splits that cost more to merge than to read
MIN_ROWS_PER_SPLIT = 64


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(b: int, s: int, hq: int, kvh: int, sm_count: int
         ) -> tuple[int, int]:
    """-> (group_tile, splits): query heads per CTA (1 for G = 1, else 8;
    the kernel keeps their q and accumulators in registers and masks the
    heads of a tile past G) and KV splits, so the partial kernel's grid
    holds at most two CTAs per SM: the bf16 G = 8 instance needs ~250
    registers a thread, so two of its CTAs fit on an SM, and a grid of
    one wave leaves no tail."""
    g = hq // kvh
    group_tile = 1 if g == 1 else 8
    ctas = b * kvh * -(-g // group_tile)
    splits = max(1, min(2 * sm_count // ctas,
                        -(-s // MIN_ROWS_PER_SPLIT)))
    return group_tile, splits


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, D); k, v (B, S, KVH, D); cache_len (B,) int32 ->
    (B, Hq, D) in q's type: the kernel on CUDA, the plain version on the
    CPU."""
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_decode: q must be float32 or bfloat16, "
                         f"got {q.dtype}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} must be "
                         f"(B, Hq, D) and k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} both (B, S, KVH, D)")
    b, hq, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or s < 1 or hq % kvh != 0:
        raise ValueError(f"flash_decode: k {tuple(k.shape)} does not fit "
                         f"q {tuple(q.shape)} (Hq must be a multiple of "
                         "KVH, S >= 1)")
    if d % 8 != 0 or d > 256:
        raise ValueError(f"flash_decode: D={d} must be a multiple of 8 up "
                         "to 256")
    for name, t, dt in (("q", q, q.dtype), ("k", k, q.dtype),
                        ("v", v, q.dtype), ("cache_len", cache_len,
                                            torch.int32)):
        if t.device != q.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"flash_decode: {name} must be a contiguous "
                             f"{dt} tensor on {q.device}, got {t.dtype} "
                             f"on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} must be 16-byte "
                             "aligned")
    if cache_len.shape != (b,):
        raise ValueError(f"flash_decode: cache_len {tuple(cache_len.shape)}"
                         f" must be ({b},)")
    group_tile, splits = plan(b, s, hq, kvh, _sm_count(q.device.index
                                                       or 0))
    part_ml = torch.empty((b, hq, splits, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((b, hq, splits, d), dtype=torch.float32,
                           device=q.device)
    out = torch.empty_like(q)
    KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  cache_len.data_ptr(), part_ml.data_ptr(),
                  part_acc.data_ptr(), out.data_ptr(), b, s, hq, kvh, d,
                  group_tile, splits, int(q.dtype == torch.bfloat16))
    return out
