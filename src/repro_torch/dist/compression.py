"""int8 wire compression with error feedback for collectives (port of
``repro.dist.compression``), on a ``torch.distributed`` process group.

Two users, as in the reference:

- ``compressed_psum`` — error-feedback int8 mean-reduction for gradient
  aggregation.  Each rank quantizes (gradient + carried residual) to int8
  with a local absmax scale, dequantizes, and all-reduces the dequantized
  tensors; the quantization error is carried into the next step, so the
  truncation never accumulates bias.  No schedule calls it (as in the
  reference); its tests do.
- :class:`QuantizedAllToAll` — the error-feedback int8 all-to-all of the
  two per-layer feature redistributions of the snapshot-partitioned block
  (``core.partition.snapshot_block_body``), through
  :func:`quantized_t_to_n` / :func:`quantized_n_to_t`.  Each rank
  quantizes every destination piece with its own absmax scale, ships the
  int8 payload and a ``(P,)`` f32 scale vector through the counted
  ``dist.sharding.all_to_all``, and keeps the untransmitted error as a
  residual for the next round.  The backward is the transposed quantized
  all-to-all of the cotangent, without error feedback (cotangents are not
  reused across rounds), so gradient bytes shrink with activation bytes.

Where the reference's host mesh ships the dequantized f32 arrays, the
port hands the collective the int8 codes themselves: the
``partition.a2a_bytes`` counters see one byte an element plus the scale
vectors.  Quantization rounds half to even (``torch.round``, as
``jnp.round``) on ``g32 / scale`` with the scale clamped to [tiny, max],
so the codes and scales equal the reference's on the same input.  The
quantize and dequantize passes are plain PyTorch, as the reference's are
plain ``jnp``: no kernel of its own.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.dist import sharding

_QMAX = 127.0
_TINY = torch.finfo(torch.float32).tiny
_FMAX = torch.finfo(torch.float32).max

# ExecutionPlan.compression values: "none" keeps today's f32 paths
# bit-exact; "int8_a2a" quantizes the two per-layer feature all-to-alls;
# "int8_all" additionally narrows the host->device delta wire format
# (see stream.wire).
COMPRESSION_MODES = ("none", "int8_a2a", "int8_all")


def validate_mode(compression: str) -> str:
    if compression not in COMPRESSION_MODES:
        raise ValueError(
            f"compression must be one of {COMPRESSION_MODES}, "
            f"got {compression!r}")
    return compression


def compresses_a2a(compression: str) -> bool:
    """Whether this mode quantizes the feature all-to-alls."""
    return validate_mode(compression) != "none"


def wire_mode(compression: str) -> str:
    """The ``stream.wire`` delta format implied by a compression mode."""
    return "int8" if validate_mode(compression) == "int8_all" else "none"


def _flatten(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _flatten(t)]
    return [tree]


def _unflatten(like, leaves):
    """A tree shaped as ``like`` whose tensors are drawn from the iterator
    ``leaves``, in :func:`_flatten`'s order."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(t, leaves) for t in like)
    return next(leaves)


def init_residual(grads: Any) -> Any:
    """Zero error-feedback residuals matching the gradient tree (f32)."""
    return _unflatten(grads, (torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device)
                              for g in _flatten(grads)))


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(absmax / _QMAX, _TINY, _FMAX)


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Absmax int8 quantization: ``g ~= q * scale``.

    The scale is clamped to [tiny, finfo.max] so all-zero tensors
    quantize to zeros (not NaN) and ±inf inputs saturate to ±127
    (inf/finite_max is inf, which clips cleanly; inf/inf would be NaN).
    """
    g32 = g.to(torch.float32)
    scale = _scale(torch.amax(torch.abs(g32)))
    q = torch.clamp(torch.round(g32 / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_quantize(g: torch.Tensor, res: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback step: quantize ``g + res``, return the
    dequantized value actually transmitted and the new residual.

    By construction ``deq == (g + res) - new_res``, so over K steps the
    transmitted sum telescopes:
    ``sum(deq_k) == sum(g_k) + res_0 - res_K``.
    """
    g32 = g.to(torch.float32) + res
    q, scale = quantize(g32)
    deq = dequantize(q, scale)
    return deq, g32 - deq


def compressed_psum(grads: Any, group, residual: Any) -> tuple[Any, Any]:
    """Error-feedback int8 mean-reduction over the ranks of ``group``.

    Returns (reduced mean tree, new residual tree); the residual stays
    on the rank.  Each leaf is all-reduced in its dequantized f32 form,
    one collective a leaf (the reference's psum of the dequantized
    values), then divided by the group size."""
    p = float(sharding.group_size(group))
    red, new_res = [], []
    for g, res in zip(_flatten(grads), _flatten(residual), strict=True):
        deq, nr = ef_quantize(g, res)
        dist.all_reduce(deq, group=group)
        red.append((deq / p).to(g.dtype))
        new_res.append(nr)
    return (_unflatten(grads, iter(red)), _unflatten(grads, iter(new_res)))


# ------------------------------------------------ quantized all-to-all ------

def quantize_pieces(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-destination-piece absmax quantization of f32 pieces ``x``
    (P, ...) laid out piece-major, as ``dist.sharding.all_to_all`` sends
    them -> the int8 codes (same shape) and a ``(P,)`` f32 scale vector,
    one scale per piece."""
    scales = _scale(torch.amax(torch.abs(x.reshape(x.shape[0], -1)), dim=1))
    bcast = scales.reshape((-1,) + (1,) * (x.dim() - 1))
    q = torch.clamp(torch.round(x / bcast), -_QMAX, _QMAX).to(torch.int8)
    return q, scales


def dequantize_pieces(q: torch.Tensor, scales: torch.Tensor
                      ) -> torch.Tensor:
    """Inverse of :func:`quantize_pieces`, piece ``i`` by ``scales[i]``."""
    return q.to(torch.float32) * scales.reshape(
        (-1,) + (1,) * (q.dim() - 1))


def _a2a_int8(y32: torch.Tensor, group
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantized all-to-all of f32 pieces ``y32`` (P, ...): the int8 codes
    and the scale vector go through the counted all-to-all, each received
    piece is dequantized by its sender's scale.  Returns (dequantized
    output, what this rank transmitted after dequantization) — the second
    value is what error feedback subtracts from ``y32``."""
    q, scales = quantize_pieces(y32)
    sent = dequantize_pieces(q, scales)
    q_out = sharding.all_to_all(q, group)
    s_out = sharding.all_to_all(scales, group)
    return dequantize_pieces(q_out, s_out), sent


class QuantizedAllToAll(torch.autograd.Function):
    """Error-feedback int8 all-to-all of piece-major ``(y, res)`` ->
    ``(out, new_res)``.

    The forward quantizes ``y + res`` piece by piece and ships the int8
    payload and the ``(P,)`` scale vector; the untransmitted error lands
    in ``new_res``, which is not differentiable (the reference carries it
    on ``value_and_grad``'s aux output).  The backward is the transposed
    quantized all-to-all of ``out``'s cotangent, without error feedback.
    Run the forward once per round: a recompute (a checkpoint around it)
    would ship again and advance the residual twice."""

    @staticmethod
    def forward(ctx, y, res, group):
        ctx.group, ctx.dtype = group, y.dtype
        y32 = y.to(torch.float32) + res
        out, sent = _a2a_int8(y32, group)
        new_res = y32 - sent
        ctx.mark_non_differentiable(new_res)
        return out.to(y.dtype), new_res

    @staticmethod
    def backward(ctx, g_out, _g_res):
        return quantized_all_to_all(g_out, ctx.group), None, None


def quantized_all_to_all(y: torch.Tensor, group) -> torch.Tensor:
    """int8 all-to-all of piece-major ``y`` without error feedback (what
    the cotangents take), not differentiable."""
    out, _ = _a2a_int8(y.to(torch.float32), group)
    return out.to(y.dtype)


def quantized_t_to_n(h: torch.Tensor, res: torch.Tensor, group
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``sharding.t_to_n`` on the int8 wire: time-sharded (bsl, N, F) and
    its residual (same layout) -> (vertex-sharded (P bsl, N/P, F), the new
    residual (bsl, N, F))."""
    p = sharding.group_size(group)
    out, new_res = QuantizedAllToAll.apply(
        sharding.t2n_send(h, p), sharding.t2n_send(res, p), group)
    return sharding.t2n_recv(out), sharding.t2n_unsend(new_res)


def quantized_n_to_t(h: torch.Tensor, res: torch.Tensor, group
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``sharding.n_to_t`` on the int8 wire: vertex-sharded (bsize, N/P,
    F) and its residual (same layout) -> (time-sharded (bsize/P, N, F),
    the new residual (bsize, N/P, F))."""
    p = sharding.group_size(group)
    out, new_res = QuantizedAllToAll.apply(
        sharding.n2t_send(h, p), sharding.n2t_send(res, p), group)
    return sharding.n2t_recv(out), sharding.n2t_unsend(new_res)
