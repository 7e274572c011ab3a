"""Plain PyTorch version of the flash-decode kernel.

The CPU path of ``ops.decode_attention`` and the reference ``chip_smoke.py``
holds the CUDA kernel to on the card.  Port of
``repro.kernels.flash_decode.ref.flash_decode_ref`` (which
``repro.nn.attention.decode_attention_jnp`` computes too): fp32 scores,
rows ``s >= cache_len`` masked to -1e30 (not -inf, so a row with
``cache_len == 0`` gets the uniform mean of V over all S rows, no NaN),
softmax, fp32 PV product, output in q's type.  With ``return_lse`` it
also gives each head's log-sum-exp of its valid scores (B, Hq) in fp32,
the weight a row-split cache merges its slices by; then a row with
``cache_len <= 0`` has no valid row: output 0 and log-sum-exp -inf.
"""

from __future__ import annotations

import torch


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len: torch.Tensor, return_lse: bool = False):
    """q (B, Hq, D); k, v (B, S, KVH, D); cache_len (B,) -> (B, Hq, D), or
    with ``return_lse`` (that, lse (B, Hq) fp32)."""
    b, hq, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, hq // kvh, d).to(torch.float32)
    scores = torch.einsum("bhgd,bshd->bhgs", qg,
                          k.to(torch.float32)) / (d ** 0.5)
    mask = torch.arange(s, device=q.device)[None, None, None, :] \
        < cache_len.to(torch.int64)[:, None, None, None]
    if return_lse:
        scores = torch.where(mask, scores, -torch.inf)
        lse = torch.logsumexp(scores, dim=-1)
        p = torch.exp(scores - torch.where(torch.isinf(lse), 0.0,
                                           lse)[..., None])
        out = torch.einsum("bhgs,bshd->bhgd", p, v.to(torch.float32))
        return (out.reshape(b, hq, d).to(q.dtype), lse.reshape(b, hq))
    scores = torch.where(mask, scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.to(torch.float32))
    return out.reshape(b, hq, d).to(q.dtype)
