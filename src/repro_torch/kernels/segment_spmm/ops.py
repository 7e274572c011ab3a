"""``segment_spmm``: the GCN aggregate ``A_tilde @ x`` on the CSR kernel.

Port of ``repro.kernels.segment_spmm.ops.segment_spmm`` (TPU kernel
``bucketed_segment_sum``).  :func:`build_csr` makes a destination-sorted
CSR on the input's device (stable sort by destination, row pointers by
binary search of the sorted keys); :func:`segment_spmm_csr` hands a CSR to
the CUDA kernel ``csrc/segment_spmm.cu``, which fuses the gather of
``x[src] * w`` with the per-row sum.  The model builds each snapshot's
CSR once and reuses it in every layer (``core.models.forward_slice``);
:func:`segment_spmm` keeps the JAX wrapper's signature and builds its own.
``csr_builds`` counts the builds, beside ``KERNEL.launches``.  Zero-weight
lanes — the padding convention; ``apply_delta`` parks every padded lane at
edge (0, 0) — are sorted into a dump row N that the kernel never visits, so
up to a million pad lanes never pile onto destination 0.  The CSR has no
per-block edge budget, so nothing can overflow.

On a CPU tensor the wrapper runs the plain PyTorch version (``ref.py``) on
the same CSR; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import Kernel
from repro_torch.kernels.segment_spmm.ref import segment_spmm_csr_ref

KERNEL = Kernel("segment_spmm", "segment_spmm.cu", "segment_spmm_csr_f32",
                [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int])

#: the previous design (a thread per row) in the same library; no wrapper
#: calls it, ``chip_smoke.py`` times it beside the kernel
ROWTHREAD_SYMBOL = "segment_spmm_csr_f32_rowthread"

#: CSRs built by :func:`build_csr` since the last reset (a plain count)
csr_builds = 0


def build_csr(edges: torch.Tensor, edge_weights: torch.Tensor,
              num_nodes: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (row_ptr (N + 1,) int32, col (E,) int32, w (E,) f32).

    Edges are stably sorted by destination; zero-weight lanes go to the
    dump row ``num_nodes`` past ``row_ptr[N]``, where no row reads them.
    The keys are int32 (half the radix passes of int64), and row pointers
    come from a binary search of the sorted keys, so nothing here waits
    for the device (``bincount`` would read its maximum back to the host).
    """
    global csr_builds
    csr_builds += 1
    key = torch.where(edge_weights != 0, edges[:, 1].to(torch.int32),
                      num_nodes)
    key_sorted, order = torch.sort(key, stable=True)
    rows = torch.arange(num_nodes + 1, dtype=torch.int32,
                        device=edges.device)
    row_ptr = torch.searchsorted(key_sorted, rows, out_int32=True)
    col = edges[:, 0][order].to(torch.int32)
    w = edge_weights[order].to(torch.float32)
    return row_ptr, col, w


def segment_spmm_csr(x: torch.Tensor, row_ptr: torch.Tensor,
                     col: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """CSR product on a prebuilt CSR: the kernel on CUDA, the plain
    version on the CPU."""
    if x.device.type == "cpu":
        return segment_spmm_csr_ref(x, row_ptr, col, w)
    if x.device.type != "cuda":
        raise ValueError(f"segment_spmm: unsupported device {x.device}")
    n, f = x.shape
    for name, t, dt in (("x", x, torch.float32),
                        ("row_ptr", row_ptr, torch.int32),
                        ("col", col, torch.int32), ("w", w, torch.float32)):
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"segment_spmm: {name} must be a contiguous "
                             f"{dt} tensor on {x.device}, got {t.dtype} "
                             f"on {t.device}")
    if row_ptr.shape != (n + 1,) or col.shape != w.shape:
        raise ValueError(f"segment_spmm: row_ptr {tuple(row_ptr.shape)} / "
                         f"col {tuple(col.shape)} / w {tuple(w.shape)} do "
                         f"not fit x {tuple(x.shape)}")
    out = torch.empty_like(x)
    KERNEL.launch(x.device, x.data_ptr(), row_ptr.data_ptr(),
                  col.data_ptr(), w.data_ptr(), out.data_ptr(), n, f)
    return out


def segment_spmm(x: torch.Tensor, edges: torch.Tensor,
                 edge_weights: torch.Tensor, num_nodes: int
                 ) -> torch.Tensor:
    """``A_tilde @ x``; x (N, F) f32, edges (E, 2) int (src, dst),
    edge_weights (E,) with zero on padded lanes -> (N, F)."""
    if x.shape[0] != num_nodes:
        raise ValueError(f"segment_spmm: x has {x.shape[0]} rows, "
                         f"num_nodes={num_nodes}")
    row_ptr, col, w = build_csr(edges, edge_weights, num_nodes)
    return segment_spmm_csr(x.contiguous(), row_ptr, col, w)
