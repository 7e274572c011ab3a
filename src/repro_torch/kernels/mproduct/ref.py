"""Plain PyTorch version of the banded-TTM kernels.

The CPU path of ``ops.banded_ttm`` / ``ops.banded_ttm_t`` and the
reference ``chip_smoke.py`` holds the CUDA kernels to on the card.  Same
band and denominator as the kernels.  ``banded_ttm_ref`` is the forward
over the kept rows: M applied to [prefix (lead rows); x (T_s rows)], row 0
at global index ``t_offset``; kept output row t (t >= lead) sums input
rows k in [max(0, t - w + 1, -t_offset), t] in fp32, in ascending k from
zero, and divides once by min(w, t + t_offset + 1); a row whose band is
empty is zero.  ``banded_ttm_t_ref`` is the plain version of the
transposed band over the kept rows (the backward kernel): input row k
receives dZ[t - lead] / min(w, t + t_offset + 1) from every kept output
row t (t >= lead) whose band holds it.  ``m_matrix`` is the dense M of
a slice, the reference's oracle for both.
"""

from __future__ import annotations

import torch


def m_matrix(num_steps: int, window: int, t_offset: int = 0
             ) -> torch.Tensor:
    """Dense (T_s, T_s) f32 M of a slice whose row 0 is global index
    ``t_offset``: M[t, k] = 1 / min(w, g) for the band's columns k at or
    after global step 1, g = t + t_offset + 1; a column before the slice
    is dropped (port of ``repro.kernels.mproduct.ref.m_matrix``)."""
    g = torch.arange(num_steps, dtype=torch.float64) + t_offset + 1
    band = ((g[None, :] <= g[:, None]) & (g[None, :] >= 1)
            & (g[None, :] > g[:, None] - window))
    denom = torch.clamp(torch.minimum(g, torch.tensor(float(window))),
                        min=1.0)
    return torch.where(band, 1.0 / denom[:, None], 0.0).to(torch.float32)


def _denominators(lead: int, rows: int, window: int, t_offset: int,
                  like: torch.Tensor) -> torch.Tensor:
    """min(w, g) of rows lead .. rows - 1 (g their 1-indexed global step),
    1 where g < 1, as f32 shaped to broadcast over ``like``'s rows."""
    g = torch.arange(lead, rows, device=like.device) + t_offset + 1
    denom = torch.clamp(torch.minimum(g, torch.full_like(g, window)), min=1)
    return denom.to(torch.float32).reshape((rows - lead,)
                                           + (1,) * (like.dim() - 1))


def banded_ttm_ref(prefix: torch.Tensor, x: torch.Tensor, window: int,
                   t_offset: int = 0) -> torch.Tensor:
    """Rows lead .. lead + T_s - 1 of M [prefix; x] -> (T_s, ...), where
    prefix (lead, ...) and x (T_s, ...) are read where they lie (no
    concatenation) and ``t_offset`` is the global index of prefix row 0
    (of x row 0 when lead = 0: M x).  Each band is summed in ascending k
    from zero -- the kernel's fp32 operations in its order."""
    lead, t_s = prefix.shape[0], x.shape[0]
    rows = lead + t_s
    pf, xf = prefix.to(torch.float32), x.to(torch.float32)
    first = max(0, -t_offset)               # the row of global step 1
    acc = torch.zeros((t_s,) + tuple(x.shape[1:]), dtype=torch.float32,
                      device=x.device)
    for d in range(window - 1, -1, -1):
        # kept row t gets input row t - d (oldest first: ascending k) when
        # that row exists and lies at or after global step 1
        t0 = max(lead, first + d)
        # input rows k in [t0 - d, rows - d) feed kept row k + d - lead
        k0, kp, kx = t0 - d, min(lead, rows - d), max(t0 - d, lead)
        if k0 < kp:                         # those in the prefix
            acc[k0 + d - lead:kp + d - lead] += pf[k0:kp]
        if kx < rows - d:                   # those in x
            acc[kx + d - lead:] += xf[kx - lead:t_s - d]
    return (acc / _denominators(lead, rows, window, t_offset, acc)
            ).to(x.dtype)


def banded_ttm_t_ref(dz: torch.Tensor, window: int, t_offset: int = 0,
                     lead: int = 0, write_lead: bool = True
                     ) -> torch.Tensor:
    """M^T [0 (lead rows); dz] over a (lead + T_s)-row tensor whose row 0
    has global index ``t_offset``: each dz row divided once by its row's
    denominator, each output's band summed in ascending t from zero ->
    (lead + T_s, ...), or its last T_s rows when not ``write_lead``."""
    t_s = dz.shape[0]
    rows = lead + t_s
    scaled = dz.to(torch.float32) / _denominators(lead, rows, window,
                                                  t_offset, dz)
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
