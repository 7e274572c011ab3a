"""Frozen work counts of a cell's train step, from its shapes alone, and
the H100's published peaks.

By the measuring guide's rule: each input byte read once, each output byte
written once, forward and backward FLOPs, nothing recomputed, whatever the
implementation reads again.  All counts are a rank's, per step (a rank
holds T / P snapshots; the temporal stage's N / P vertices do the same
work, so the counts divide by P).  ``nnz = edges_per_snapshot + N`` lanes
carry a weight (the self-loops included); padded lanes carry none and are
not counted.  A CSR of N rows and nnz lanes is ``4 (N + 1) + 8 nnz``
bytes (row pointers, int32 columns, float32 weights).

* whole step (``step_work``): bytes = the graph's CSR (once: the
  forward's aggregates and the backward's transposed ones read the same
  topology) + frames ``4 T N F_in`` + labels ``4 T N`` + parameters and
  AdamW state (read, written); FLOPs = forward + backward of the
  aggregates (``2 nnz d`` a product; layer 0's input takes no gradient),
  the GCN products (``2 N d_in d_out``, backward twice that), the
  temporal stage (M-product ``2 min(w, t) N d`` each way; LSTM gates ``2 N
  (d_x + d_h) 4 d_h`` forward, twice that backward, and ``10 N d_h`` of
  elementwise work a step each way) and the classifier (``2 N d C``,
  backward twice that);
* ``segment_spmm`` (``spmm_bytes``): each aggregate launch's CSR read
  once, its X rows read once, its Y written once: the forward at layer
  0's and layer 1's input widths and the backward on the transposed CSR
  at layer 1's (T of each a step);
* ``banded_ttm`` and ``banded_ttm_t`` (``ttm_bytes``): TM-GCN's M-product
  input read once and output written once a layer, forward and backward:
  ``4 * 4 T N d_out`` a layer.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, float32 outside the tensor cores, HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def layer_dims(cfg: dict) -> list[tuple[int, int, int]]:
    """[(d_in, d_gcn, d_out)] a layer, as both models size them."""
    out, d = [], cfg["feat_in"]
    for l in range(cfg["num_layers"]):
        d_out = cfg["out_dim"] if l == cfg["num_layers"] - 1 else \
            cfg["hidden"]
        d_gcn = cfg["hidden"] if cfg["model"] == "cdgcn" else d_out
        out.append((d, d_gcn, d_out))
        d = d_out
    return out


def _shape(traffic: dict) -> tuple[int, int, int, int]:
    """-> (T a rank, N, nnz, ranks)."""
    p = traffic["ranks"]
    return (traffic["steps"] // p, traffic["nodes"],
            traffic["edges_per_snapshot"] + traffic["nodes"], p)


def csr_bytes(n: int, nnz: int) -> int:
    return 4 * (n + 1) + 8 * nnz


def param_count(cfg: dict) -> int:
    total = 0
    for d_in, d_gcn, d_out in layer_dims(cfg):
        total += d_in * d_gcn + d_gcn
        if cfg["model"] == "cdgcn":
            total += (d_in + d_gcn + d_out) * 4 * d_out + 4 * d_out
    return total + cfg["out_dim"] * cfg["num_classes"] + cfg["num_classes"]


def _mproduct_macs(t: int, window: int) -> int:
    """Multiply-adds of the band over a t-step timeline, per column."""
    return sum(min(window, g) for g in range(1, t + 1))


def step_work(cfg: dict, traffic: dict) -> tuple[float, float]:
    """-> (FLOPs, bytes) of one train step on one rank."""
    t, n, nnz, p = _shape(traffic)
    c = cfg["num_classes"]
    fwd = bwd = 0.0
    for l, (d_in, d_gcn, d_out) in enumerate(layer_dims(cfg)):
        fwd += t * 2.0 * nnz * d_in
        bwd += t * 2.0 * nnz * d_in if l > 0 else 0.0
        fwd += t * 2.0 * n * d_in * d_gcn
        bwd += t * 4.0 * n * d_in * d_gcn
        if cfg["model"] == "tmgcn":
            band = 2.0 * _mproduct_macs(traffic["steps"], cfg["window"]) \
                * n * d_out / p
            fwd += band
            bwd += band
        elif cfg["model"] == "cdgcn":
            gates = t * 2.0 * n * (d_in + d_gcn + d_out) * 4 * d_out
            fwd += gates + t * 10.0 * n * d_out
            bwd += 2 * gates + t * 10.0 * n * d_out
    fwd += t * 2.0 * n * cfg["out_dim"] * c
    bwd += t * 4.0 * n * cfg["out_dim"] * c
    state = 4 * 4 * param_count(cfg) * 2          # params, m, v, master
    nbytes = t * (csr_bytes(n, nnz) + 4 * n * cfg["feat_in"] + 4 * n) \
        + state
    return fwd + bwd, float(nbytes)


def spmm_bytes(cfg: dict, traffic: dict) -> float:
    """Least bytes of one step's ``segment_spmm`` launches on one rank."""
    t, n, nnz, _ = _shape(traffic)
    csr = csr_bytes(n, nnz)
    total = 0
    dims = layer_dims(cfg)
    for l, (d_in, _, _) in enumerate(dims):
        total += csr + 8 * n * d_in               # forward
        if l > 0:
            total += csr + 8 * n * d_in           # backward on A^T
    return float(t * total)


def ttm_bytes(cfg: dict, traffic: dict) -> float:
    """Least bytes of one step's ``banded_ttm`` and ``banded_ttm_t``
    launches on one rank (0 for a model without the M-product)."""
    if cfg["model"] != "tmgcn":
        return 0.0
    t, n, _, _ = _shape(traffic)
    return float(sum(4 * 4 * t * n * d_out
                     for _, _, d_out in layer_dims(cfg)))


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two rates."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
