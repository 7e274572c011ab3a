"""Checkpoint save / restore of the port (``ckpt.checkpoint``)."""

from repro_torch.ckpt.checkpoint import Checkpointer, flatten_with_paths

__all__ = ["Checkpointer", "flatten_with_paths"]
