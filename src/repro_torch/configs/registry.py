"""Architecture registry of the port: ``arch=<id>`` selects a config.

Port of ``repro.configs.registry`` for the dyngnn archs (``tmgcn``,
``cdgcn``, ``evolvegcn``, ``paper_dyngnn``), the LM archs (dense
``yi-6b``, ``gemma-7b``, ``minicpm-2b``; MoE ``olmoe-1b-7b``,
``moonshot-v1-16b-a3b``) and the static-GNN archs (``gatedgcn``, ``pna``,
``schnet``, ``equiformer-v2``), which carry the reference's shape set
(:func:`gnn_shapes`), and the recsys arch ``din`` with its four shapes
(:func:`recsys_shapes`): every arch the reference registers, each with
the reference's shape set (the LMs' :func:`lm_shapes`, the dyngnn archs'
one ``dtdg_train`` shape per dataset scale).
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str              # train | prefill | decode | dtdg_train |
    #                        full_graph | minibatch | molecule |
    #                        recsys_train | recsys_serve | retrieval
    dims: dict


@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str            # dyngnn | lm | gnn | recsys
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
    "repro_torch.configs.din",
    "repro_torch.configs.paper_dyngnn",
]


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _REGISTRY:
        load_all()      # one config module imported alone registers one
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; have "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def all_archs() -> dict[str, ArchSpec]:
    """Every arch, in ``ARCH_MODULES``' order (the reference's, where a
    fresh process imports them in that order), whichever module a caller
    imported first."""
    load_all()          # a config module imported alone registers one
    rank = {m: i for i, m in enumerate(ARCH_MODULES)}
    return dict(sorted(_REGISTRY.items(),
                       key=lambda kv: rank[kv[1].make_config.__module__]))


def load_all() -> None:
    for mod in ARCH_MODULES:
        importlib.import_module(mod)


def lm_shapes() -> dict:
    """The LMs' input shapes, as in the reference."""
    return {
        "train_4k": ShapeSpec("train_4k", "train",
                              {"seq_len": 4096, "global_batch": 256}),
        "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                                 {"seq_len": 32768, "global_batch": 32}),
        "decode_32k": ShapeSpec("decode_32k", "decode",
                                {"seq_len": 32768, "global_batch": 128}),
        "long_500k": ShapeSpec("long_500k", "decode",
                               {"seq_len": 524288, "global_batch": 1,
                                "kv_seq_shard": True}),
    }


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


def recsys_shapes() -> dict:
    """DIN's input shapes, as in the reference."""
    return {
        "train_batch": ShapeSpec("train_batch", "recsys_train",
                                 {"batch": 65536}),
        "serve_p99": ShapeSpec("serve_p99", "recsys_serve", {"batch": 512}),
        "serve_bulk": ShapeSpec("serve_bulk", "recsys_serve",
                                {"batch": 262144}),
        "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval",
                                    {"batch": 1,
                                     "n_candidates": 1_000_000}),
    }
