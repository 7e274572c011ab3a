"""``repro_torch`` — the PyTorch + CUDA port of ``repro`` for NVIDIA H100.

Module names mirror ``src/repro/`` so each piece has an obvious
counterpart; the JAX package stays the reference the port's tests hold it
to.  The port imports ``torch`` and never ``jax`` or ``repro``: host-side
numpy it needs (CTDG bridging, the graph-diff encoder) is kept as its own
copy, pinned byte-identical by ``tests/test_torch_stream.py``.

Slice 1 is online TM-GCN serving (``repro_torch.serve``): CTDG events ->
host graph-diff encoder -> pinned, non-blocking transfer -> on-device delta
apply -> Laplacian weights -> one window of the GCN + temporal stack ->
micro-batched node / link queries.  Its two hot ops run hand-written CUDA
kernels (``repro_torch.kernels``; sources in ``csrc/``).

Entry points run on the card: ``device`` defaults to ``"cuda"`` and they
raise when no CUDA device is present unless the caller passes
``device="cpu"`` (as the CPU tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; never drops quietly to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: the port "
                         "runs on 'cuda' or 'cpu'")
    return dev
