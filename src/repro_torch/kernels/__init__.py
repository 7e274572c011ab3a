"""Hand-written Hopper kernels of the port and their plain versions.

Each kernel has a wrapper (``ops.py``) that checks its inputs, launches the
CUDA kernel on the current stream for CUDA tensors and counts the launch,
and a plain PyTorch version (``ref.py``) that the wrapper runs for CPU
tensors.  Sources are in ``repro_torch/csrc``; ``build.py`` compiles them.
A kernel that training differentiates through has a
``torch.autograd.Function`` beside it whose backward is a kernel too
(``segment_spmm`` on the transposed CSR; ``banded_ttm_t``).
"""

from repro_torch.kernels.flash_decode import ops as flash_decode_ops
from repro_torch.kernels.mproduct import ops as mproduct_ops
from repro_torch.kernels.segment_spmm import ops as segment_spmm_ops

#: every kernel of the port, in build order
ALL = (segment_spmm_ops.KERNEL, mproduct_ops.KERNEL, mproduct_ops.KERNEL_T,
       flash_decode_ops.KERNEL)
