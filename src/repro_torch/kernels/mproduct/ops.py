"""``banded_ttm`` / ``m_product``: TM-GCN's M-product on the CUDA kernel.

Port of ``repro.kernels.mproduct.ops.m_product`` (TPU kernel
``banded_ttm``).  Y = M x_1 X with M[t, k] = 1/min(w, g) on the band
max(1, g - w + 1) <= k_g <= g, g the 1-indexed global step; ``t_offset``
(the global index of row 0) is a runtime argument.  The kernels are
``csrc/banded_ttm.cu``.  On a CPU tensor a wrapper runs the plain PyTorch
version (``ref.py``); on a CUDA tensor it launches the kernel or raises.

Both kernels work on the rows a caller keeps.  The forward,
``banded_ttm``, reads [prefix (lead rows); x (T_s rows)] through two
pointers, with no concatenated copy, and writes only the T_s kept rows,
rows lead .. lead + T_s - 1 of M [prefix; x].  Training differentiates
through :class:`MProductWithPrefixFn` (that forward, keeping x's rows;
``m_product`` is it over an empty prefix).  It takes its gradient from
``banded_ttm_t``, the kernel ``banded_ttm_t_f32`` of the same source (its
own :class:`Kernel` and launch count; plain version
``ref.banded_ttm_t_ref``), which reads only the kept rows' gradient dZ and
writes the prefix's and the slice's gradients as one buffer:
dX[k] = sum over kept rows t in [max(k, lead), min(lead + T_s - 1,
k + w - 1)] of dZ[t - lead] / min(w, t + t_offset + 1), for rows
k >= -t_offset only.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import Kernel
from repro_torch.kernels.mproduct.ref import banded_ttm_ref, banded_ttm_t_ref

KERNEL = Kernel("banded_ttm", "banded_ttm.cu", "banded_ttm_f32",
                [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_int])
#: the transposed band over the kept rows (the backward); one library of
#: its own.  Arguments: dz, out, t_s, nf, window, t_offset, ``lead`` and
#: the first output row written.
KERNEL_T = Kernel("banded_ttm_t", "banded_ttm.cu", "banded_ttm_t_f32",
                  [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong] + [ctypes.c_int] * 4)


def _on_card(kernel: Kernel, x: torch.Tensor, window: int) -> bool:
    """False for a CPU tensor (the plain version serves it); True for a
    CUDA tensor the kernel takes; raises on anything else."""
    if window < 1:
        raise ValueError(f"{kernel.name}: window must be >= 1, got {window}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{kernel.name}: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{kernel.name}: x must be a contiguous 2-D "
                         f"float32 tensor, got {x.dtype} {tuple(x.shape)}")
    return True


def banded_ttm(prefix: torch.Tensor, x: torch.Tensor, window: int,
               t_offset: int = 0) -> torch.Tensor:
    """The band over kept rows: prefix (lead, NF) and x (T_s, NF) f32,
    row 0 of [prefix; x] at global index ``t_offset``; returns rows
    lead .. lead + T_s - 1 of M [prefix; x], (T_s, NF).  ``lead = 0``:
    M x."""
    if prefix.device != x.device:
        raise ValueError(f"banded_ttm: prefix and x lie on {prefix.device} "
                         f"and {x.device}")
    if not _on_card(KERNEL, x, window):
        return banded_ttm_ref(prefix, x, window, t_offset)
    (t_s, nf), lead = x.shape, prefix.shape[0]
    if prefix.dtype != x.dtype or prefix.dim() != 2 or \
            prefix.shape[1] != nf or not prefix.is_contiguous():
        raise ValueError(f"banded_ttm: prefix must be a contiguous "
                         f"(lead, {nf}) tensor like x, got {prefix.dtype} "
                         f"{tuple(prefix.shape)}")
    out = torch.empty_like(x)
    KERNEL.launch(x.device, prefix.data_ptr(), x.data_ptr(), out.data_ptr(),
                  lead, t_s, nf, int(window), int(t_offset))
    return out


def banded_ttm_t(dz: torch.Tensor, window: int, t_offset: int = 0,
                 lead: int = 0, write_lead: bool = True) -> torch.Tensor:
    """The transposed band over kept rows: dz (T_s, NF) f32 is the gradient
    of rows lead .. lead + T_s - 1 of M's output over a (lead + T_s)-row
    tensor whose row 0 has global index ``t_offset``; returns
    M^T [0; dz], (lead + T_s, NF), or its last T_s rows alone when not
    ``write_lead``.  ``lead = 0``: M^T dz."""
    if lead < 0:
        raise ValueError(f"banded_ttm_t: lead must be >= 0, got {lead}")
    if not _on_card(KERNEL_T, dz, window):
        return banded_ttm_t_ref(dz, window, t_offset, lead, write_lead)
    t_s, nf = dz.shape
    first = 0 if write_lead else lead
    out = torch.empty((lead + t_s - first, nf), dtype=dz.dtype,
                      device=dz.device)
    KERNEL_T.launch(dz.device, dz.data_ptr(), out.data_ptr(), t_s, nf,
                    int(window), int(t_offset), int(lead), first)
    return out


class MProductWithPrefixFn(torch.autograd.Function):
    """The M-product over ``[prefix, x]`` ((lead, N, F), lead w - 1 or 0,
    and (T_s, N, F)), keeping x's rows; ``t_offset`` is the global index
    of x[0].  The forward is one ``banded_ttm`` launch on the two inputs
    as they lie, writing only x's rows; its backward is one
    ``banded_ttm_t`` launch on the kept rows' gradient, which writes the
    prefix's and x's gradients as two views of one buffer (x's alone
    when the prefix needs none).  It saves no tensor."""

    @staticmethod
    def forward(ctx, prefix: torch.Tensor, x: torch.Tensor, window: int,
                t_offset: int) -> torch.Tensor:
        lead, t_s = prefix.shape[0], x.shape[0]
        ctx.window, ctx.t_offset, ctx.lead = window, t_offset, lead
        ctx.prefix_shape, ctx.x_shape = prefix.shape, x.shape
        nf = math.prod(x.shape[1:])
        z = banded_ttm(prefix.reshape(lead, nf).contiguous(),
                       x.reshape(t_s, nf).contiguous(), window,
                       t_offset - lead)
        return z.view(x.shape)

    @staticmethod
    def backward(ctx, dz: torch.Tensor):
        lead, (t_s, *_) = ctx.lead, ctx.x_shape
        with_prefix = ctx.needs_input_grad[0]
        g = banded_ttm_t(dz.reshape(t_s, -1).contiguous(), ctx.window,
                         ctx.t_offset - lead, lead, with_prefix)
        if not with_prefix:
            return None, g.view(ctx.x_shape), None, None
        return (g[:lead].view(ctx.prefix_shape), g[lead:].view(ctx.x_shape),
                None, None)


def m_product(x: torch.Tensor, window: int, t_offset: int = 0
              ) -> torch.Tensor:
    """TM-GCN temporal op on a (T, N, F) tensor through ``banded_ttm``
    (differentiable: the backward is ``banded_ttm_t``): the M-product over
    an empty prefix."""
    prefix = x.new_empty((0,) + tuple(x.shape[1:]))
    return MProductWithPrefixFn.apply(prefix, x, window, t_offset)
