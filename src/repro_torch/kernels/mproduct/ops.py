"""``banded_ttm`` / ``m_product``: TM-GCN's M-product on the CUDA kernel.

Port of ``repro.kernels.mproduct.ops.m_product`` (TPU kernel
``banded_ttm``).  Y = M x_1 X with M[t, k] = 1/min(w, g) on the band
max(1, g - w + 1) <= k_g <= g, g the 1-indexed global step; ``t_offset``
(the global index of row 0, negative under ``m_product_with_prefix``) is a
runtime argument.  The kernel is ``csrc/banded_ttm.cu``.  On a CPU tensor
the wrapper runs the plain PyTorch version (``ref.py``); on a CUDA tensor
it launches the kernel or raises.

Training differentiates through :class:`BandedTTMFn`, whose gradient
``dX = M^T dY`` is the kernel ``banded_ttm_t_f32`` in the same source (its
own :class:`Kernel` and launch count; plain version ``ref.banded_ttm_t_ref``):
dX[k] = sum over t in [k, min(T - 1, k + w - 1)] of dY[t] / min(w, t +
t_offset + 1), for rows k >= -t_offset only.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import Kernel
from repro_torch.kernels.mproduct.ref import banded_ttm_ref, banded_ttm_t_ref

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
KERNEL = Kernel("banded_ttm", "banded_ttm.cu", "banded_ttm_f32", _ARGTYPES)
#: the transposed band (the backward); one library of its own
KERNEL_T = Kernel("banded_ttm_t", "banded_ttm.cu", "banded_ttm_t_f32",
                  _ARGTYPES)


def _run(kernel: Kernel, plain, x: torch.Tensor, window: int,
         t_offset: int) -> torch.Tensor:
    """The plain version on a CPU tensor, the kernel on a CUDA one."""
    if window < 1:
        raise ValueError(f"{kernel.name}: window must be >= 1, got {window}")
    if x.device.type == "cpu":
        return plain(x, window, t_offset)
    if x.device.type != "cuda":
        raise ValueError(f"{kernel.name}: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{kernel.name}: x must be a contiguous 2-D "
                         f"float32 tensor, got {x.dtype} {tuple(x.shape)}")
    t, nf = x.shape
    out = torch.empty_like(x)
    kernel.launch(x.device, x.data_ptr(), out.data_ptr(), t, nf,
                  int(window), int(t_offset))
    return out


def banded_ttm(x: torch.Tensor, window: int, t_offset: int = 0
               ) -> torch.Tensor:
    """x (T, NF) f32 -> (T, NF): the band of M applied along axis 0."""
    return _run(KERNEL, banded_ttm_ref, x, window, t_offset)


def banded_ttm_t(dy: torch.Tensor, window: int, t_offset: int = 0
                 ) -> torch.Tensor:
    """dy (T, NF) f32 -> (T, NF): the transposed band, M^T dy."""
    return _run(KERNEL_T, banded_ttm_t_ref, dy, window, t_offset)


class BandedTTMFn(torch.autograd.Function):
    """``M x_1 X`` on a (T, NF) tensor; its gradient ``M^T dY`` through the
    transposed kernel.  The band has no parameters."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, window: int, t_offset: int
                ) -> torch.Tensor:
        ctx.window, ctx.t_offset = window, t_offset
        return banded_ttm(x, window, t_offset)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        dx = banded_ttm_t(dy.contiguous(), ctx.window, ctx.t_offset) \
            if ctx.needs_input_grad[0] else None
        return dx, None, None


def m_product(x: torch.Tensor, window: int, t_offset: int = 0
              ) -> torch.Tensor:
    """TM-GCN temporal op on a (T, N, F) tensor through ``banded_ttm``
    (differentiable: the backward is ``banded_ttm_t``)."""
    t = x.shape[0]
    y = BandedTTMFn.apply(x.reshape(t, -1).contiguous(), window, t_offset)
    return y.reshape(x.shape)
