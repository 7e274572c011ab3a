"""``banded_ttm`` / ``m_product``: TM-GCN's M-product on the CUDA kernel.

Port of ``repro.kernels.mproduct.ops.m_product`` (TPU kernel
``banded_ttm``).  Y = M x_1 X with M[t, k] = 1/min(w, g) on the band
max(1, g - w + 1) <= k_g <= g, g the 1-indexed global step; ``t_offset``
(the global index of row 0, negative under ``m_product_with_prefix``) is a
runtime argument.  The kernel is ``csrc/banded_ttm.cu``.  On a CPU tensor
the wrapper runs the plain PyTorch version (``ref.py``); on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import Kernel
from repro_torch.kernels.mproduct.ref import banded_ttm_ref

KERNEL = Kernel("banded_ttm", "banded_ttm.cu", "banded_ttm_f32",
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_longlong, ctypes.c_int, ctypes.c_int])


def banded_ttm(x: torch.Tensor, window: int, t_offset: int = 0
               ) -> torch.Tensor:
    """x (T, NF) f32 -> (T, NF): the band of M applied along axis 0."""
    if window < 1:
        raise ValueError(f"banded_ttm: window must be >= 1, got {window}")
    if x.device.type == "cpu":
        return banded_ttm_ref(x, window, t_offset)
    if x.device.type != "cuda":
        raise ValueError(f"banded_ttm: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"banded_ttm: x must be a contiguous 2-D float32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    t, nf = x.shape
    out = torch.empty_like(x)
    KERNEL.launch(x.device, x.data_ptr(), out.data_ptr(), t, nf,
                  int(window), int(t_offset))
    return out


def m_product(x: torch.Tensor, window: int, t_offset: int = 0
              ) -> torch.Tensor:
    """TM-GCN temporal op on a (T, N, F) tensor through ``banded_ttm``."""
    t = x.shape[0]
    y = banded_ttm(x.reshape(t, -1).contiguous(), window, t_offset)
    return y.reshape(x.shape)
