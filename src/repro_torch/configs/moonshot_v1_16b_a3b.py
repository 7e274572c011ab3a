"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B]: 48L, d=2048,
16H (kv=16), MoE 64 experts top-6, expert ff=1408, vocab=163840.  Port of
``repro.configs.moonshot_v1_16b_a3b``."""

import torch

from repro_torch.configs.registry import ArchSpec, lm_shapes, register
from repro_torch.models.lm import LMConfig


def make_config() -> LMConfig:
    return LMConfig(name="moonshot-v1-16b-a3b", num_layers=48, d_model=2048,
                    num_heads=16, num_kv_heads=16, head_dim=128, d_ff=1408,
                    vocab_size=163840, activation="silu", moe_experts=64,
                    moe_top_k=6, dtype=torch.bfloat16)


def make_smoke_config() -> LMConfig:
    return LMConfig(name="moonshot-smoke", num_layers=2, d_model=64,
                    num_heads=2, num_kv_heads=2, head_dim=32, d_ff=96,
                    vocab_size=512, activation="silu", moe_experts=8,
                    moe_top_k=2, dtype=torch.float32)


register(ArchSpec(arch_id="moonshot-v1-16b-a3b", family="lm",
                  make_config=make_config,
                  make_smoke_config=make_smoke_config,
                  shapes=lm_shapes()))
