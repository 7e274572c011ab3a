"""Yi-6B [arXiv:2403.04652]: llama-arch GQA, 32L, d=4096, 32H/4KV, ff=11008,
vocab=64000.  Port of ``repro.configs.yi_6b``."""

import torch

from repro_torch.configs.registry import ArchSpec, lm_shapes, register
from repro_torch.models.lm import LMConfig


def make_config() -> LMConfig:
    return LMConfig(name="yi-6b", num_layers=32, d_model=4096, num_heads=32,
                    num_kv_heads=4, head_dim=128, d_ff=11008,
                    vocab_size=64000, activation="silu",
                    rope_theta=5_000_000.0, dtype=torch.bfloat16)


def make_smoke_config() -> LMConfig:
    return LMConfig(name="yi-6b-smoke", num_layers=2, d_model=128,
                    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=344,
                    vocab_size=512, activation="silu", dtype=torch.float32)


register(ArchSpec(arch_id="yi-6b", family="lm", make_config=make_config,
                  make_smoke_config=make_smoke_config,
                  shapes=lm_shapes()))
