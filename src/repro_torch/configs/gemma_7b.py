"""Gemma-7B [arXiv:2403.08295]: 28L, d=3072, 16H (kv=16), head_dim=256,
GeGLU ff=24576, vocab=256000, (1+w)-RMSNorm, sqrt(d) embedding scale.
Port of ``repro.configs.gemma_7b``."""

import torch

from repro_torch.configs.registry import ArchSpec, lm_shapes, register
from repro_torch.models.lm import LMConfig


def make_config() -> LMConfig:
    return LMConfig(name="gemma-7b", num_layers=28, d_model=3072,
                    num_heads=16, num_kv_heads=16, head_dim=256, d_ff=24576,
                    vocab_size=256000, activation="gelu",
                    rms_plus_one=True, embed_scale=True,
                    dtype=torch.bfloat16)


def make_smoke_config() -> LMConfig:
    return LMConfig(name="gemma-7b-smoke", num_layers=2, d_model=96,
                    num_heads=2, num_kv_heads=2, head_dim=48, d_ff=384,
                    vocab_size=512, activation="gelu", rms_plus_one=True,
                    embed_scale=True, dtype=torch.float32)


register(ArchSpec(arch_id="gemma-7b", family="lm", make_config=make_config,
                  make_smoke_config=make_smoke_config,
                  shapes=lm_shapes()))
