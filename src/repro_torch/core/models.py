"""The three representative dynamic-GNN models (paper §5), forward only.

Port of ``repro.core.models``.  Every model is a stack of (GCN, RNN) layer
pairs with an explicit *temporal carry* per layer:

    carry_in -(layer forward over a timeline slice)-> (outputs, carry_out)

The carry is the paper's pi_b block-boundary data (§3.1): the RNN state at
the slice boundary plus the last (w-1) activations for windowed temporal
ops.  Parameters live in :class:`ParamTree`, an ``nn.Module`` whose
``state_dict`` keys mirror the JAX parameter tree (``layers.0.gcn.w``,
``classifier.u``, ...) and which is indexed like the JAX dicts
(``params["layers"][0]["gcn"]["w"]``), so the functions below read as
their JAX counterparts do.  Training (losses, backward kernels) waits for
ROADMAP Queue 1, item 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

from repro_torch.core import gcn as gcnlib
from repro_torch.core import temporal
from repro_torch.kernels.segment_spmm import ops as spmm_ops


@dataclass(frozen=True)
class DynGNNConfig:
    model: str = "tmgcn"            # cdgcn | evolvegcn | tmgcn
    num_nodes: int = 1024
    feat_in: int = 2                # paper: in/out degree features
    hidden: int = 6                 # paper: intermediate feature length 6
    out_dim: int = 6                # embedding length F'
    num_layers: int = 2
    window: int = 5                 # M-product / RNN window w
    num_classes: int = 2
    # no use_pallas counterpart: the kernel wrappers pick the CUDA kernel
    # or its plain version from the tensors' device

    def layer_dims(self) -> list[tuple[int, int, int]]:
        """[(d_in, d_gcn, d_out_of_layer)] per layer."""
        dims = []
        d = self.feat_in
        for l in range(self.num_layers):
            d_out = self.out_dim if l == self.num_layers - 1 else self.hidden
            dims.append((d, self.hidden, d_out))
            d = d_out
        return dims


class ParamTree(nn.Module):
    """A node of the parameter tree: dict keys become submodules (dicts),
    ``nn.ModuleList``s (lists) or parameters (tensors)."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(k, nn.ModuleList(ParamTree(c) for c in v))
            else:
                self.register_parameter(k, nn.Parameter(torch.as_tensor(v)))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return hasattr(self, key)


# ------------------------------------------------------------- init ---------

def init_params(gen: torch.Generator, cfg: DynGNNConfig) -> ParamTree:
    """Fresh parameters from a ``torch.Generator`` (the port's own init:
    the distributions of ``repro.core.models.init_params``, not its
    numbers — load those with ``repro_torch.convert.params_from_jax``)."""
    layers = []
    for d_in, d_gcn, d_out in cfg.layer_dims():
        layer: dict = {}
        if cfg.model == "cdgcn":
            layer["gcn"] = gcnlib.init_gcn_params(gen, d_in, d_gcn)
            # concat skip makes the LSTM input (d_in + d_gcn)-wide
            layer["lstm"] = temporal.init_lstm_params(gen, d_in + d_gcn,
                                                      d_out)
        elif cfg.model == "evolvegcn":
            layer["evolve"] = temporal.init_weight_lstm_params(gen, d_in,
                                                               d_out)
        elif cfg.model == "tmgcn":
            layer["gcn"] = gcnlib.init_gcn_params(gen, d_in, d_out)
        else:
            raise ValueError(cfg.model)
        layers.append(layer)
    scale = 1.0 / cfg.out_dim ** 0.5
    u = torch.rand((cfg.out_dim, cfg.num_classes), generator=gen) \
        * (2 * scale) - scale
    return ParamTree({
        "layers": layers,
        "classifier": {"u": u, "b": torch.zeros((cfg.num_classes,))}})


def init_layer_carry(cfg: DynGNNConfig, params: ParamTree, layer: int,
                     dtype=torch.float32, device=None) -> Any:
    """Zero temporal carry (pi_0) for one layer.  EvolveGCN's weight carry
    starts as ``w0`` itself (an alias — see ``serve.state.fresh_carries``)."""
    n = cfg.num_nodes
    _, _, d_out = cfg.layer_dims()[layer]
    if cfg.model == "cdgcn":
        return temporal.lstm_zero_state((n,), d_out, dtype, device)
    if cfg.model == "evolvegcn":
        w0 = params["layers"][layer]["evolve"]["w0"]
        f_in, f_out = w0.shape
        return (w0, temporal.lstm_zero_state((f_out,), f_in, dtype, device))
    if cfg.model == "tmgcn":
        return torch.zeros((cfg.window - 1, n, d_out), dtype=dtype,
                           device=device)
    raise ValueError(cfg.model)


def init_carries(cfg: DynGNNConfig, params: ParamTree, dtype=torch.float32,
                 device=None) -> list:
    return [init_layer_carry(cfg, params, l, dtype, device)
            for l in range(cfg.num_layers)]


# ---------------------------------------------------- layer-slice steps -----

def _identity(v: torch.Tensor) -> torch.Tensor:
    return v


def spatial_stage(cfg: DynGNNConfig, layer_params, x: torch.Tensor,
                  edges: torch.Tensor, edge_weights: torch.Tensor,
                  carry: Any, csrs: list | None = None
                  ) -> tuple[torch.Tensor, Any]:
    """The per-snapshot stage of one layer.

    x: (Ts, N, d_in) slice; edges: (Ts, E, 2); returns (Ts, N, d_mid).
    EvolveGCN folds the whole layer here (its LSTM runs over weights) and
    returns the updated weight carry.  ``csrs``: each snapshot's prebuilt
    CSR (``forward_slice`` builds them once for all layers), else built
    here.
    """
    num_nodes = x.shape[1]
    if csrs is None:
        csrs = [None] * x.shape[0]
    if cfg.model == "evolvegcn":
        w_prev, state = carry
        ws, w_last, st_last = temporal.evolve_weights_from(
            layer_params["evolve"], w_prev, state, x.shape[0])
        y = torch.stack([
            torch.relu(gcnlib.spatial_aggregate(
                x[t], edges[t], edge_weights[t], num_nodes, csrs[t]) @ ws[t])
            for t in range(x.shape[0])])
        return y, (w_last, st_last)

    act = _identity if cfg.model == "tmgcn" else torch.relu
    y = torch.stack([
        gcnlib.gcn_apply(layer_params["gcn"], x[t], edges[t],
                         edge_weights[t], num_nodes,
                         concat_skip=cfg.model == "cdgcn",
                         activation=act, csr=csrs[t])
        for t in range(x.shape[0])])
    if cfg.model == "tmgcn":
        y = torch.relu(y)
    return y, carry


def temporal_stage(cfg: DynGNNConfig, layer_params, y: torch.Tensor,
                   carry: Any, t_offset: int) -> tuple[torch.Tensor, Any]:
    """The per-vertex timeline stage of one layer. y: (Ts, N, d_mid)."""
    if cfg.model == "cdgcn":
        return temporal.lstm_scan(layer_params["lstm"], y, init_state=carry)
    if cfg.model == "evolvegcn":
        return y, carry  # already folded into the spatial stage
    if cfg.model == "tmgcn":
        z = temporal.m_product_with_prefix(y, carry, cfg.window, t_offset)
        new_prefix = torch.cat([carry, y], dim=0)[-(cfg.window - 1):] \
            if cfg.window > 1 else carry
        return z, new_prefix
    raise ValueError(cfg.model)


def forward_slice(cfg: DynGNNConfig, params: ParamTree, x: torch.Tensor,
                  edges: torch.Tensor, edge_weights: torch.Tensor,
                  carries: list, t_offset: int
                  ) -> tuple[torch.Tensor, list]:
    """Full model over a contiguous timeline slice: x (Ts, N, F),
    edges (Ts, E, 2), edge_weights (Ts, E) -> (z (Ts, N, F'), carries).

    Every layer aggregates over the same snapshots, so each snapshot's CSR
    is built once here, before the layer loop, not once per layer."""
    evolve = cfg.model == "evolvegcn"
    num_nodes = x.shape[1]
    csrs = [spmm_ops.build_csr(edges[t], edge_weights[t], num_nodes)
            for t in range(x.shape[0])]
    new_carries = []
    h = x
    for l in range(cfg.num_layers):
        lp = params["layers"][l]
        h, c_sp = spatial_stage(cfg, lp, h, edges, edge_weights,
                                carries[l] if evolve else None, csrs)
        h, c_tm = temporal_stage(cfg, lp, h,
                                 None if evolve else carries[l], t_offset)
        new_carries.append(c_sp if evolve else c_tm)
    return h, new_carries


def classify(params: ParamTree, z: torch.Tensor) -> torch.Tensor:
    """Per-(t, u) logits via the shared projection U (§2.2)."""
    return z @ params["classifier"]["u"] + params["classifier"]["b"]


def link_logits(params: ParamTree, z_t: torch.Tensor,
                pairs: torch.Tensor) -> torch.Tensor:
    """Link prediction head (§6.4): U applied to each endpoint, summed —
    a (2F' x C) FC layer on the concatenated endpoint embeddings."""
    zu = z_t[pairs[:, 0].long()]
    zv = z_t[pairs[:, 1].long()]
    u = params["classifier"]["u"]
    return zu @ u + zv @ u + params["classifier"]["b"]
