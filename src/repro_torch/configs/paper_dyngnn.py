"""The paper's own dynamic-GNN configs (TM-GCN / CD-GCN / EvolveGCN).

Port of ``repro.configs.paper_dyngnn``: full configs carry the paper's
widths (Table 1 scales in ``DATASETS``), smoke configs run on the CPU.
``paper_dyngnn`` is an alias of ``tmgcn``, the paper's headline model.
The full configs leave ``num_nodes`` at its default; a caller sizes it
from ``DATASETS`` (``dataclasses.replace(cfg, num_nodes=...)``).
"""

from repro_torch.configs.registry import ArchSpec, ShapeSpec, register
from repro_torch.core.models import DynGNNConfig

DATASETS = {
    # name: (N, T, smoothed edges per snapshot).  N and T are rounded from
    # Table 1 to multiples of 32 resp. 128, as in the JAX package.
    "epinions": (755_200, 512, 2_097_152),
    "flickr": (2_300_000, 128, 7_340_032),
    "youtube": (3_200_000, 256, 3_342_336),
    "amlsim": (1_000_000, 256, 4_194_304),
    "weak_scale": (1_048_576, 256, 3_145_728),   # weak-scaling generator
}


def _shapes():
    """One ``dtdg_train`` shape per dataset scale, as in the reference."""
    return {
        f"dtdg_{k}": ShapeSpec(
            f"dtdg_{k}", "dtdg_train",
            {"n_nodes": n, "n_steps": t, "edges_per_snap": e})
        for k, (n, t, e) in DATASETS.items()
    }


def _mk(model: str):
    def make_config():
        return DynGNNConfig(model=model, feat_in=2, hidden=6, out_dim=6,
                            num_layers=2, window=5, num_classes=2,
                            checkpoint_blocks=4)

    def make_smoke_config():
        return DynGNNConfig(model=model, num_nodes=64, num_steps=16,
                            feat_in=2, hidden=6, out_dim=6, num_layers=2,
                            window=3, num_classes=2, checkpoint_blocks=2)

    return make_config, make_smoke_config


for _arch, _model in (("tmgcn", "tmgcn"), ("cdgcn", "cdgcn"),
                      ("evolvegcn", "evolvegcn"),
                      ("paper_dyngnn", "tmgcn")):   # the headline alias
    _mc, _ms = _mk(_model)
    register(ArchSpec(arch_id=_arch, family="dyngnn", make_config=_mc,
                      make_smoke_config=_ms, shapes=_shapes()))
