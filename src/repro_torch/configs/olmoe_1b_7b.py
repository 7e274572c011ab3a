"""OLMoE-1B-7B [arXiv:2409.02060]: 16L, d=2048, 16H (kv=16), MoE 64 experts
top-8, expert ff=1024, vocab=50304.  Port of ``repro.configs.olmoe_1b_7b``."""

import torch

from repro_torch.configs.registry import ArchSpec, lm_shapes, register
from repro_torch.models.lm import LMConfig


def make_config() -> LMConfig:
    return LMConfig(name="olmoe-1b-7b", num_layers=16, d_model=2048,
                    num_heads=16, num_kv_heads=16, head_dim=128, d_ff=1024,
                    vocab_size=50304, activation="silu", moe_experts=64,
                    moe_top_k=8, dtype=torch.bfloat16)


def make_smoke_config() -> LMConfig:
    return LMConfig(name="olmoe-smoke", num_layers=2, d_model=64,
                    num_heads=2, num_kv_heads=2, head_dim=32, d_ff=64,
                    vocab_size=512, activation="silu", moe_experts=8,
                    moe_top_k=2, dtype=torch.float32)


register(ArchSpec(arch_id="olmoe-1b-7b", family="lm",
                  make_config=make_config,
                  make_smoke_config=make_smoke_config,
                  shapes=lm_shapes()))
