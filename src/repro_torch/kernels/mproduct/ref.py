"""Plain PyTorch version of the banded-TTM kernel.

The CPU path of ``ops.banded_ttm`` and the reference ``chip_smoke.py``
holds the CUDA kernel to on the card.  Same band and denominator as the
kernel: output row t sums input rows k in [max(0, t - w + 1, -t_offset), t]
in fp32 and divides by min(w, t + t_offset + 1); a row whose band is empty
is zero.
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
