"""Plain PyTorch version of the CSR segment-SpMM kernel.

The CPU path of ``ops.segment_spmm_csr`` and the reference
``chip_smoke.py`` holds the CUDA kernel to on the card.  Same inputs as the
kernel: rows ``0..N-1`` of the CSR, N = ``row_ptr.numel() - 1``, gathered
from any number of x rows; edges past ``row_ptr[N]`` (the dump row) are
never read.
"""

from __future__ import annotations

import torch


def segment_spmm_csr_ref(x: torch.Tensor, row_ptr: torch.Tensor,
                         col: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    n = row_ptr.shape[0] - 1
    nnz = int(row_ptr[-1])
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(n, device=x.device), counts, output_size=nnz)
    msgs = x[col[:nnz].long()].to(torch.float32) * w[:nnz, None]
    out = torch.zeros((n,) + x.shape[1:], dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, rows, msgs).to(x.dtype)
