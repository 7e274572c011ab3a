"""Architecture registry of the port: ``arch=<id>`` selects a config.

Port of ``repro.configs.registry`` for the dyngnn archs (``tmgcn``,
``cdgcn``, ``evolvegcn``, ``paper_dyngnn``), the LM archs (dense
``yi-6b``, ``gemma-7b``, ``minicpm-2b``; MoE ``olmoe-1b-7b``,
``moonshot-v1-16b-a3b``) and the static-GNN archs (``gatedgcn``, ``pna``,
``schnet``, ``equiformer-v2``), which carry the reference's shape set
(:func:`gnn_shapes`).  The seed's recsys arch ``din`` is known by name and
family only: asking for it raises ``NotImplementedError`` until ROADMAP
Queue 1, item 9c ports it.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str              # full_graph | minibatch | molecule (the gnn set)
    dims: dict


@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str            # dyngnn | lm | gnn; recsys: ROADMAP Queue 1, 9c
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]
    shapes: dict = field(default_factory=dict)


_REGISTRY: dict[str, ArchSpec] = {}

ARCH_MODULES = [
    "repro_torch.configs.yi_6b",
    "repro_torch.configs.gemma_7b",
    "repro_torch.configs.minicpm_2b",
    "repro_torch.configs.olmoe_1b_7b",
    "repro_torch.configs.moonshot_v1_16b_a3b",
    "repro_torch.configs.gatedgcn",
    "repro_torch.configs.pna",
    "repro_torch.configs.schnet",
    "repro_torch.configs.equiformer_v2",
    "repro_torch.configs.paper_dyngnn",
]

#: archs of the JAX package the port does not serve yet -> their family
NOT_PORTED = {"din": "recsys"}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _REGISTRY:
        load_all()      # one config module imported alone registers one
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch '{arch_id}' ({NOT_PORTED[arch_id]} family) is not ported "
            "to PyTorch yet: ROADMAP Queue 1, item 9c")
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; have "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def load_all() -> None:
    for mod in ARCH_MODULES:
        importlib.import_module(mod)


def gnn_shapes() -> dict:
    """The static GNNs' input shapes, as in the reference."""
    return {
        "full_graph_sm": ShapeSpec(
            "full_graph_sm", "full_graph",
            {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433,
             "num_classes": 7}),
        "minibatch_lg": ShapeSpec(
            "minibatch_lg", "minibatch",
            {"n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
             "fanouts": (15, 10), "d_feat": 602, "num_classes": 41}),
        "ogb_products": ShapeSpec(
            "ogb_products", "full_graph",
            {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100,
             "num_classes": 47}),
        "molecule": ShapeSpec(
            "molecule", "molecule",
            {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 16,
             "num_classes": 2}),
    }
