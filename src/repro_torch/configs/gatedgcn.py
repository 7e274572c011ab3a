"""GatedGCN [arXiv:2003.00982 benchmark config]: 16L, d_hidden=70.
Port of ``repro.configs.gatedgcn``: the same full and smoke configs."""

from dataclasses import dataclass

from repro_torch.configs.registry import ArchSpec, gnn_shapes, register


@dataclass(frozen=True)
class GatedGCNConfig:
    name: str = "gatedgcn"
    kind: str = "gatedgcn"
    n_layers: int = 16
    d_hidden: int = 70


def make_config():
    return GatedGCNConfig()


def make_smoke_config():
    return GatedGCNConfig(name="gatedgcn-smoke", n_layers=3, d_hidden=16)


register(ArchSpec(arch_id="gatedgcn", family="gnn", make_config=make_config,
                  make_smoke_config=make_smoke_config, shapes=gnn_shapes()))
