"""MiniCPM-2B [arXiv:2404.06395]: 40L, d=2304, 36H (kv=36), ff=5760,
vocab=122753 (padded to 122880), WSD LR schedule.  Port of
``repro.configs.minicpm_2b``."""

import torch

from repro_torch.configs.registry import ArchSpec, lm_shapes, register
from repro_torch.models.lm import LMConfig


def make_config() -> LMConfig:
    return LMConfig(name="minicpm-2b", num_layers=40, d_model=2304,
                    num_heads=36, num_kv_heads=36, head_dim=64, d_ff=5760,
                    vocab_size=122753, activation="silu",
                    lr_schedule="wsd", dtype=torch.bfloat16)


def make_smoke_config() -> LMConfig:
    return LMConfig(name="minicpm-2b-smoke", num_layers=2, d_model=96,
                    num_heads=4, num_kv_heads=4, head_dim=24, d_ff=240,
                    vocab_size=512, activation="silu", lr_schedule="wsd",
                    dtype=torch.float32)


register(ArchSpec(arch_id="minicpm-2b", family="lm",
                  make_config=make_config,
                  make_smoke_config=make_smoke_config,
                  shapes=lm_shapes()))
