"""Plain PyTorch version of the banded-TTM kernel.

The CPU path of ``ops.banded_ttm`` and the reference ``chip_smoke.py``
holds the CUDA kernel to on the card.  Same band and denominator as the
kernel: output row t sums input rows k in [max(0, t - w + 1, -t_offset), t]
in fp32 and divides by min(w, t + t_offset + 1); a row whose band is empty
is zero.  ``banded_ttm_t_ref`` is the plain version of the transposed
band (the backward kernel): input row k receives dY[t] / min(w, t + t_offset
+ 1) from every output row t whose band holds it.
"""

from __future__ import annotations

import torch


def banded_ttm_ref(x: torch.Tensor, window: int, t_offset: int = 0
                   ) -> torch.Tensor:
    t = x.shape[0]
    xf = x.to(torch.float32)
    acc = torch.zeros_like(xf)
    for d in range(min(window, t)):
        # input row k = row - d contributes when it exists and its global
        # step k + t_offset + 1 is >= 1
        first = max(d, -t_offset + d, 0)
        if first < t:
            acc[first:] += xf[first - d:t - d]
    g = torch.arange(t, device=x.device) + t_offset + 1
    denom = torch.clamp(torch.minimum(g, torch.full_like(g, window)), min=1)
    shape = (t,) + (1,) * (x.dim() - 1)
    return (acc / denom.to(torch.float32).reshape(shape)).to(x.dtype)


def banded_ttm_t_ref(dy: torch.Tensor, window: int, t_offset: int = 0
                     ) -> torch.Tensor:
    t = dy.shape[0]
    g = torch.arange(t, device=dy.device) + t_offset + 1
    denom = torch.clamp(torch.minimum(g, torch.full_like(g, window)), min=1)
    shape = (t,) + (1,) * (dy.dim() - 1)
    scaled = dy.to(torch.float32) / denom.to(torch.float32).reshape(shape)
    acc = torch.zeros_like(scaled)
    for d in range(min(window, t)):
        acc[:t - d] += scaled[d:]          # row k gets output row k + d
    # rows before global step 1 lie in no band
    acc[:max(0, min(t, -t_offset))] = 0.0
    return acc.to(dy.dtype)
