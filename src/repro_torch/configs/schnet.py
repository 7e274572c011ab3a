"""SchNet [arXiv:1706.08566]: 3 interactions, d_hidden=64, 300 RBF,
cutoff 10 A.
Port of ``repro.configs.schnet``: the same full and smoke configs."""

from dataclasses import dataclass

from repro_torch.configs.registry import ArchSpec, gnn_shapes, register


@dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    kind: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0


def make_config():
    return SchNetConfig()


def make_smoke_config():
    return SchNetConfig(name="schnet-smoke", n_interactions=2, d_hidden=16,
                        n_rbf=20)


register(ArchSpec(arch_id="schnet", family="gnn", make_config=make_config,
                  make_smoke_config=make_smoke_config, shapes=gnn_shapes()))
