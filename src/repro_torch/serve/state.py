"""The state-advance / query split of online dyngnn serving.

Port of ``repro.serve.state``.

* the STATE-ADVANCE step runs once per closed time window: the window's
  reconstructed edge list (from the ``DeltaApplier`` ring) gets self-loops
  and Laplacian weights, the layer stack runs over the length-1 timeline
  slice, and the per-layer temporal carries roll forward.  Where JAX
  donated the carries to a jitted step, the port writes the rolled state
  into the same tensors in place, so resident state stays O(state) for a
  stream of any length.  The math is ``stream.train_loop.advance_slice``,
  and the session's initial state ``fresh_carries`` lives beside it (the
  streamed trainer starts each epoch from it too);
* the QUERY steps are pure reads against the resident embeddings ``z_t``:
  gather the requested rows, apply the classifier (node scoring) or the
  link head (link prediction).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import models as mdl
from repro_torch.stream.train_loop import advance_slice, fresh_carries

__all__ = ["fresh_carries", "make_advance_step", "make_link_query_step",
           "make_node_query_step"]


def _copy_into(dst: Any, src: Any) -> None:
    """Write the rolled carry ``src`` into the resident tensors ``dst``."""
    if isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src, strict=True):
            _copy_into(d, s)
    else:
        dst.copy_(src)


def make_advance_step(cfg: mdl.DynGNNConfig):
    """State advance for one serve window.

    (params, carries, frame (N, F), edges (E, 2), mask (E,), values (E,),
    t_offset) -> (z_t (N, F'), carries).  ``z_t`` is the warm-state cache
    the query steps read.  The carries are rolled IN PLACE and the same
    list is returned: callers rebind from the result, as they did with the
    JAX step that donated its carries.
    """

    @torch.inference_mode()
    def advance(params, carries, frame, edges, mask, values, t_offset):
        z, new_carries = advance_slice(cfg, params, carries, frame[None],
                                       edges[None], mask[None],
                                       values[None], t_offset)
        _copy_into(carries, new_carries)
        return z[0], carries

    return advance


def make_node_query_step():
    """Batched node-scoring read: (params, z (N, F'), ids (B,)) -> per-class
    logits (B, C).  B is a static bucket size — callers pad."""

    @torch.inference_mode()
    def query(params, z, ids):
        return mdl.classify(params, z[ids.long()])

    return query


def make_link_query_step():
    """Batched link-prediction read: (params, z (N, F'), pairs (B, 2))
    -> logits (B, C) via the paper's §6.4 link head."""

    @torch.inference_mode()
    def query(params, z, pairs):
        return mdl.link_logits(params, z, pairs)

    return query
