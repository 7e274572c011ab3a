"""Compact host->device wire formats for the delta stream.

Host numpy, a copy of ``repro.stream.wire`` whose items are held
byte-identical to the reference's by ``tests/test_torch_dist_stream.py``.

A ``SnapshotDelta`` ships f32 drop/add masks, int32 indices, and an f32
value lane per device slot — conservative widths for payloads that are
churn-sized and low-precision by nature.  :func:`quantize_delta` narrows
the delta to the int8/int16 wire:

* drop positions index the previous device edge list — int16 when
  ``max_edges`` fits, int32 otherwise;
* added edges carry node ids — int16 when ``num_nodes`` fits;
* drop/add masks are 0/1 — int8;
* edge values are absmax-int8 quantized with ONE f32 scale per delta
  (the only lossy lane; traces with unit weights quantize exactly since
  ``127/127 * absmax == absmax``).

``FullSnapshot`` items (block boundaries and churn-overflow resyncs) are
deliberately left on the f32 format: they are the lossless escape hatch
that re-bases the device state, so wire drift can never compound across
block boundaries.  The device-side decode (widen + apply) lives in
``stream.prefetch``; byte accounting in ``dist.comm_volume``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.graphdiff import SnapshotDelta

WIRE_MODES = ("none", "int8")

_QMAX = 127.0
_INT16_MAX = 32767


def validate_wire(wire: str) -> str:
    if wire not in WIRE_MODES:
        raise ValueError(f"wire must be one of {WIRE_MODES}, got {wire!r}")
    return wire


def index_dtype(max_index: int) -> np.dtype:
    """Narrowest signed integer dtype holding indices up to
    ``max_index`` inclusive."""
    return np.dtype(np.int16 if max_index <= _INT16_MAX else np.int32)


def quantize_values(v: np.ndarray) -> tuple[np.ndarray, np.float32]:
    """Host-side absmax int8 quantization: ``v ~= q * scale``.

    Mirrors ``repro_torch.dist.compression.quantize``: the scale is clamped to
    [tiny, finfo.max] so all-zero lanes stay zero and ±inf saturates.
    """
    v32 = np.asarray(v, dtype=np.float32)
    absmax = float(np.max(np.abs(v32))) if v32.size else 0.0
    scale = np.float32(np.clip(absmax / _QMAX,
                               np.finfo(np.float32).tiny,
                               np.finfo(np.float32).max))
    q = np.clip(np.rint(v32 / scale), -_QMAX, _QMAX).astype(np.int8)
    return q, scale


def dequantize_values(q: np.ndarray, scale) -> np.ndarray:
    return q.astype(np.float32) * np.float32(scale)


@dataclass
class QuantizedDelta:
    """A ``SnapshotDelta`` on the narrow wire (same pad lengths, same
    decode semantics after widening — see ``prefetch.DeltaApplier``)."""
    drop_pos: np.ndarray      # (drop_pad,) int16/int32 device positions
    drop_mask: np.ndarray     # (drop_pad,) int8 0/1
    add_edges: np.ndarray     # (add_pad, 2) int16/int32 node ids
    add_mask: np.ndarray      # (add_pad,) int8 0/1
    values_q: np.ndarray      # (max_edges,) int8
    values_scale: np.float32  # one scale per delta
    num_edges: int

    @property
    def payload_bytes(self) -> int:
        """Valid-lane wire bytes, same counting convention as
        ``SnapshotDelta.payload_bytes`` (d*4 + a*8 + E*4 there):
        narrowed indices, one byte per valid value, one f32 scale."""
        d = int(np.sum(self.drop_mask))
        a = int(np.sum(self.add_mask))
        return (d * self.drop_pos.dtype.itemsize
                + a * 2 * self.add_edges.dtype.itemsize
                + self.num_edges * 1 + 4)


def quantize_delta(delta: SnapshotDelta, num_nodes: int,
                   max_edges: int) -> QuantizedDelta:
    """Narrow one delta to the int8/int16 wire format."""
    q, scale = quantize_values(delta.values)
    return QuantizedDelta(
        drop_pos=np.asarray(delta.drop_pos,
                            dtype=index_dtype(max_edges - 1)),
        drop_mask=np.asarray(delta.drop_mask, dtype=np.int8),
        add_edges=np.asarray(delta.add_edges,
                             dtype=index_dtype(num_nodes - 1)),
        add_mask=np.asarray(delta.add_mask, dtype=np.int8),
        values_q=q, values_scale=scale,
        num_edges=delta.num_edges)
