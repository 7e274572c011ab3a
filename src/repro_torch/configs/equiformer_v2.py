"""EquiformerV2 [arXiv:2306.12059]: 12L, d_hidden=128, l_max=6, m_max=2,
8 heads, SO(2)-eSCN equivariant graph attention.
Port of ``repro.configs.equiformer_v2``: the same full and smoke configs."""

from dataclasses import dataclass

from repro_torch.configs.registry import ArchSpec, gnn_shapes, register


@dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer-v2"
    kind: str = "equiformer_v2"
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 16
    cutoff: float = 10.0


def make_config():
    return EquiformerV2Config()


def make_smoke_config():
    return EquiformerV2Config(name="equiformer-v2-smoke", n_layers=2,
                              d_hidden=16, l_max=3, m_max=2, n_heads=4,
                              n_rbf=8)


register(ArchSpec(arch_id="equiformer-v2", family="gnn",
                  make_config=make_config,
                  make_smoke_config=make_smoke_config, shapes=gnn_shapes()))
