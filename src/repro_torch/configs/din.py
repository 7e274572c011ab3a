"""DIN [arXiv:1706.06978]: embed_dim=18, hist seq_len=100, attn MLP 80-40,
MLP 200-80, target attention.  Port of ``repro.configs.din``: the same
full and smoke configs and the reference's four recsys shapes."""

from repro_torch.configs.registry import ArchSpec, recsys_shapes, register
from repro_torch.models.din import DINConfig


def make_config() -> DINConfig:
    return DINConfig()


def make_smoke_config() -> DINConfig:
    return DINConfig(name="din-smoke", embed_dim=8, seq_len=10,
                     attn_hidden=(16, 8), mlp_hidden=(32, 16),
                     item_vocab=1000, cate_vocab=100, user_vocab=1000)


register(ArchSpec(arch_id="din", family="recsys", make_config=make_config,
                  make_smoke_config=make_smoke_config,
                  shapes=recsys_shapes()))
