"""``decode_attention``: one new token's GQA attention on the split-KV
CUDA kernel.

Port of ``repro.kernels.flash_decode.ops.decode_attention`` (TPU kernel
``flash_decode``).  The kernel is ``csrc/flash_decode.cu``: a partial
kernel over (splits, KV heads x head groups, B) that streams each split's
K/V rows once for all the query heads sharing them, then a combine kernel
that merges the splits.  The partial kernel has two instances: on tensor
cores (bf16, G > 1, D <= 128: Yi-6B's decode) and on CUDA cores (f32,
G = 1, larger D).  :func:`plan` picks the instance and the split count;
the wrapper checks what the shapes, types and devices decide once per key
and caches the answer, checks contiguity and alignment on every call, and
allocates the fp32 scratch of the partials.  Any S is
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
#: splits that cost more to merge than to read (a tile of the tensor-core
#: instance)
MIN_ROWS_PER_SPLIT = 64

#: the tensor-core instance: query heads per CTA (the MMA's 16 rows), the
#: cache rows of a tile and the stages of its shared-memory ring, as in
#: ``csrc/flash_decode.cu``
TC_HEADS = 16
TC_ROWS = 64
TC_STAGES = 3
TC_MAX_D = 128

#: CTAs of the partial kernel per SM that ``plan`` fills the card with:
#: the CUDA-core G = 8 instance needs ~250 registers a thread; the
#: tensor-core instance 102 KB of shared memory at D 128
CTAS_PER_SM = 2


def tc_smem_bytes(d: int) -> int:
    """Dynamic shared memory of the tensor-core instance at head dim d:
    its ring of K and V tiles, rows padded by 8 elements (D is padded to
    the instance's 64 or 128)."""
    dt = 64 if d <= 64 else 128
    return TC_STAGES * 2 * TC_ROWS * (dt + 8) * 2


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(b: int, s: int, hq: int, kvh: int, d: int, bf16: bool,
         sm_count: int) -> tuple[int, int]:
    """-> (group_tile, splits).  group_tile is the instance and the query
    heads per CTA: 16 for the tensor-core instance (bf16, G > 1,
    D <= 128; the heads of a group are zero-padded to 16), else the
    CUDA-core one, 1 for G = 1 and 8 otherwise (heads past G masked).
    splits cuts each sequence's rows so the partial kernel's grid holds
    at most ``CTAS_PER_SM`` CTAs per SM: one wave, no tail."""
    g = hq // kvh
    if bf16 and g > 1 and d <= TC_MAX_D:
        group_tile = TC_HEADS
    else:
        group_tile = 1 if g == 1 else 8
    ctas = b * kvh * -(-g // group_tile)
    splits = max(1, min(CTAS_PER_SM * sm_count // ctas,
                        -(-s // MIN_ROWS_PER_SPLIT)))
    return group_tile, splits


#: launch settings by (shapes, types, devices): the checks below that
#: depend only on these run once per key
_launch_cfg: dict = {}


def _checked_cfg(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cache_len: torch.Tensor) -> tuple:
    """Check what the shapes, types and devices decide, once per key ->
    (b, s, hq, kvh, d, group_tile, splits, is_bf16)."""
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
    for name, t, dt in (("k", k, q.dtype), ("v", v, q.dtype),
                        ("cache_len", cache_len, torch.int32)):
        if t.device != q.device or t.dtype != dt:
            raise ValueError(f"flash_decode: {name} must be a {dt} tensor "
                             f"on {q.device}, got {t.dtype} on {t.device}")
    if cache_len.shape != (b,):
        raise ValueError(f"flash_decode: cache_len {tuple(cache_len.shape)}"
                         f" must be ({b},)")
    bf16 = q.dtype == torch.bfloat16
    group_tile, splits = plan(b, s, hq, kvh, d, bf16,
                              _sm_count(q.device.index or 0))
    return b, s, hq, kvh, d, group_tile, splits, int(bf16)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, D); k, v (B, S, KVH, D); cache_len (B,) int32 ->
    (B, Hq, D) in q's type: the kernel on CUDA, the plain version on the
    CPU."""
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, cache_len)
    key = (q.shape, k.shape, v.shape, cache_len.shape, q.dtype, k.dtype,
           v.dtype, cache_len.dtype, q.device, k.device, v.device,
           cache_len.device)
    cfg = _launch_cfg.get(key)
    if cfg is None:
        cfg = _launch_cfg[key] = _checked_cfg(q, k, v, cache_len)
    b, s, hq, kvh, d, group_tile, splits, bf16 = cfg
    # what the tensors themselves decide, every call: the kernel reads
    # them as dense rows with 16-byte loads
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), cache_len.data_ptr())
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and cache_len.is_contiguous()) \
            or (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) % 16:
        raise ValueError("flash_decode: q, k, v and cache_len must be "
                         "contiguous and 16-byte aligned")
    # one fp32 scratch: the partial (m, l) then the partial acc
    n_part = b * hq * splits
    scratch = torch.empty(n_part * (2 + d), dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(q)
    part_ml = scratch.data_ptr()
    KERNEL.launch(q.device, ptrs[0], ptrs[1], ptrs[2], ptrs[3], part_ml,
                  part_ml + 8 * n_part, out.data_ptr(), b, s, hq, kvh, d,
                  group_tile, splits, bf16)
    return out
