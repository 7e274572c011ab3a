"""PNA [arXiv:2004.05718]: 4L, d_hidden=75, mean/max/min/std aggregators,
identity/amplification/attenuation scalers.
Port of ``repro.configs.pna``: the same full and smoke configs."""

from dataclasses import dataclass

from repro_torch.configs.registry import ArchSpec, gnn_shapes, register


@dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    kind: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75


def make_config():
    return PNAConfig()


def make_smoke_config():
    return PNAConfig(name="pna-smoke", n_layers=2, d_hidden=12)


register(ArchSpec(arch_id="pna", family="gnn", make_config=make_config,
                  make_smoke_config=make_smoke_config, shapes=gnn_shapes()))
