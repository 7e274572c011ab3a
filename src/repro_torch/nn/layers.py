"""Transformer substrate: norms, dense projections, gated FFNs.

Port of ``repro.nn.layers``.  Parameters are plain dicts of tensors in the
JAX package's layouts (``(d_in, d_out)`` weights); ``init_*`` draw from a
``torch.Generator`` on its device, ``*_apply`` are plain PyTorch products
(the JAX package leaves them to XLA, the port to cuBLAS).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in fp32; ``plus_one`` uses the (1 + w) parametrization
    (Gemma)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xn = xf * torch.rsqrt(var + eps)
    w = weight.to(torch.float32)
    if plus_one:
        w = 1.0 + w
    return (xn * w).to(x.dtype)


def normal(gen: torch.Generator, shape: tuple[int, ...], scale: float,
           dtype: torch.dtype) -> torch.Tensor:
    """fp32 normals times ``scale``, cast to ``dtype``, on ``gen``'s
    device."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(dtype)


def init_dense(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.bfloat16, lead: tuple[int, ...] = ()
               ) -> torch.Tensor:
    """(*lead, d_in, d_out) with N(0, 1 / d_in) entries; ``lead`` stacks
    independent draws (the layer axis)."""
    return normal(gen, lead + (d_in, d_out), 1.0 / d_in ** 0.5, dtype)


ACTIVATIONS: dict[str, Callable] = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def init_glu_ffn(gen: torch.Generator, d_model: int, d_ff: int,
                 dtype=torch.bfloat16, lead: tuple[int, ...] = ()) -> dict:
    """Gated FFN (SwiGLU / GeGLU; the activation is chosen at apply
    time)."""
    return {
        "wi_gate": init_dense(gen, d_model, d_ff, dtype, lead),
        "wi_up": init_dense(gen, d_model, d_ff, dtype, lead),
        "wo": init_dense(gen, d_ff, d_model, dtype, lead),
    }


def glu_ffn_apply(params: dict, x: torch.Tensor,
                  activation: str = "silu") -> torch.Tensor:
    act = ACTIVATIONS[activation]
    gate = act(x @ params["wi_gate"])
    up = x @ params["wi_up"]
    return (gate * up) @ params["wo"]


def init_mlp(gen: torch.Generator, dims: list[int],
             dtype=torch.float32) -> list[dict]:
    """Plain MLP stack (the recsys / GNN heads)."""
    return [{"w": init_dense(gen, dims[i], dims[i + 1], dtype),
             "b": torch.zeros((dims[i + 1],), dtype=dtype,
                              device=gen.device)}
            for i in range(len(dims) - 1)]


def mlp_apply(layers: list[dict], x: torch.Tensor, activation: str = "relu",
              final_activation: bool = False) -> torch.Tensor:
    act = ACTIVATIONS[activation]
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1 or final_activation:
            x = act(x)
    return x
