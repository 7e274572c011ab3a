"""Architecture registry of the port: ``arch=<id>`` selects a config.

Port of ``repro.configs.registry`` for the dyngnn archs (``tmgcn``,
``cdgcn``, ``evolvegcn``, ``paper_dyngnn``) and the LM archs (dense
``yi-6b``, ``gemma-7b``, ``minicpm-2b``; MoE ``olmoe-1b-7b``,
``moonshot-v1-16b-a3b``).  The seed's recsys and static-GNN archs are
known by name and family only: asking for one raises
``NotImplementedError`` until ROADMAP Queue 1, item 9 ports them.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str            # dyngnn | lm; gnn | recsys: ROADMAP Queue 1, item 9
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]


_REGISTRY: dict[str, ArchSpec] = {}

ARCH_MODULES = [
    "repro_torch.configs.yi_6b",
    "repro_torch.configs.gemma_7b",
    "repro_torch.configs.minicpm_2b",
    "repro_torch.configs.olmoe_1b_7b",
    "repro_torch.configs.moonshot_v1_16b_a3b",
    "repro_torch.configs.paper_dyngnn",
]

#: archs of the JAX package the port does not serve yet -> their family
NOT_PORTED = {
    "gatedgcn": "gnn", "pna": "gnn", "schnet": "gnn",
    "equiformer-v2": "gnn", "din": "recsys",
}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    if not _REGISTRY:
        load_all()
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch '{arch_id}' ({NOT_PORTED[arch_id]} family) is not ported "
            "to PyTorch yet: ROADMAP Queue 1, item 9")
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; have "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def load_all() -> None:
    for mod in ARCH_MODULES:
        importlib.import_module(mod)
