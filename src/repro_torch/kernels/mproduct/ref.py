"""Plain PyTorch version of the banded-TTM kernel.

The CPU path of ``ops.banded_ttm`` and the reference ``chip_smoke.py``
holds the CUDA kernel to on the card.  Same band and denominator as the
kernel: output row t sums input rows k in [max(0, t - w + 1, -t_offset), t]
in fp32 and divides by min(w, t + t_offset + 1); a row whose band is empty
is zero.  ``banded_ttm_t_ref`` is the plain version of the transposed
band over the kept rows (the backward kernel): input row k receives
dZ[t - lead] / min(w, t + t_offset + 1) from every kept output row t
(t >= lead) whose band holds it.
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


def banded_ttm_t_ref(dz: torch.Tensor, window: int, t_offset: int = 0,
                     lead: int = 0, write_lead: bool = True
                     ) -> torch.Tensor:
    """M^T [0 (lead rows); dz] over a (lead + T_s)-row tensor whose row 0
    has global index ``t_offset``: each dz row divided once by its row's
    denominator, each output's band summed in ascending t from zero ->
    (lead + T_s, ...), or its last T_s rows when not ``write_lead``."""
    t_s = dz.shape[0]
    rows = lead + t_s
    g = torch.arange(lead, rows, device=dz.device) + t_offset + 1
    denom = torch.clamp(torch.minimum(g, torch.full_like(g, window)), min=1)
    shape = (t_s,) + (1,) * (dz.dim() - 1)
    scaled = dz.to(torch.float32) / denom.to(torch.float32).reshape(shape)
    acc = torch.zeros((rows,) + tuple(dz.shape[1:]), dtype=torch.float32,
                      device=dz.device)
    for d in range(window):
        # output row k gets kept row k + d, which is dz row k + d - lead
        k0, s0 = max(0, lead - d), max(0, d - lead)
        if s0 < t_s:
            acc[k0:k0 + t_s - s0] += scaled[s0:]
    # rows before global step 1 lie in no band
    acc[:max(0, min(rows, -t_offset))] = 0.0
    return acc[0 if write_lead else lead:].to(dz.dtype)
