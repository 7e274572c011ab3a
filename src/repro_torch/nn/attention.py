"""GQA attention: prefill (full / query-chunked causal) and decode.

Port of ``repro.nn.attention``.  Prefill attention is plain PyTorch
(matmuls, -1e30 masking, fp32 softmax, probabilities cast to q's type
before the PV product), as the JAX package leaves it to XLA; the
query-chunked form bounds the live score tensor to (chunk x S) and is taken
above ``CHUNK_THRESHOLD``.  Decode attention is the ``flash_decode`` kernel
wrapper (``repro_torch.kernels.flash_decode.ops.decode_attention``): the
CUDA kernel for tensors on the card, its plain version on the CPU.  It
computes what ``repro.nn.attention.decode_attention_jnp`` computes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_decode.ops import decode_attention
from repro_torch.nn.layers import normal
from repro_torch.nn.rope import apply_rope

__all__ = ["CHUNK_THRESHOLD", "DEFAULT_Q_CHUNK", "attention_apply",
           "causal_attention", "chunked_causal_attention",
           "decode_attention", "decode_step_attention", "init_attention",
           "output_projection", "prefill_attention", "project_qkv"]

CHUNK_THRESHOLD = 2048
DEFAULT_Q_CHUNK = 1024
_NEG_INF = -1e30


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                   lead: tuple[int, ...] = ()) -> dict:
    """wq (d, H, D), wk / wv (d, KVH, D), wo (H, D, d), N(0, 1/d) entries;
    ``lead`` stacks independent draws (the layer axis)."""
    scale = 1.0 / d_model ** 0.5
    return {
        "wq": normal(gen, lead + (d_model, n_heads, head_dim), scale, dtype),
        "wk": normal(gen, lead + (d_model, n_kv_heads, head_dim), scale,
                     dtype),
        "wv": normal(gen, lead + (d_model, n_kv_heads, head_dim), scale,
                     dtype),
        "wo": normal(gen, lead + (n_heads, head_dim, d_model), scale, dtype),
    }


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KVH, D) -> (B, S, KVH * G, D) by repetition (GQA)."""
    if groups == 1:
        return k
    b, s, kvh, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kvh, groups, d) \
        .reshape(b, s, kvh * groups, d)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_offset: int = 0) -> torch.Tensor:
    """Full causal softmax attention. q: (B, Sq, H, D); k, v: (B, Sk, KVH, D).

    q_offset: absolute position of q[0] (for chunked calls) -- query i may
    attend keys j <= i + q_offset.
    """
    sq, h, d = q.shape[1:]
    kvh = k.shape[2]
    k = _repeat_kv(k, h // kvh)
    v = _repeat_kv(v, h // kvh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    scores = scores / (d ** 0.5)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    scores = torch.where(kpos <= qpos, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             q_chunk: int = DEFAULT_Q_CHUNK) -> torch.Tensor:
    """Causal attention over the query axis in chunks.

    Live memory per chunk: (B, H, q_chunk, S) scores instead of
    (B, H, S, S).  Exact: each chunk sees the full key prefix.
    """
    s = q.shape[1]
    if s % q_chunk != 0 or s == q_chunk:
        return causal_attention(q, k, v)
    return torch.cat([causal_attention(q[:, i:i + q_chunk], k, v,
                                       q_offset=i)
                      for i in range(0, s, q_chunk)], dim=1)


def project_qkv(params: dict, x: torch.Tensor, positions: torch.Tensor,
                rope_theta: float
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (..., d_model) -> q (..., H, D), k and v (..., KVH, D), RoPE on q
    and k at ``positions`` (the leading dims but the last of x)."""
    def proj(w):
        return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])

    q, k, v = proj(params["wq"]), proj(params["wk"]), proj(params["wv"])
    return (apply_rope(q, positions, rope_theta),
            apply_rope(k, positions, rope_theta), v)


def output_projection(params: dict, o: torch.Tensor) -> torch.Tensor:
    """o (..., H, D) -> (..., d_model) through wo (H, D, d_model)."""
    wo = params["wo"]
    return o.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


def prefill_attention(params: dict, x: torch.Tensor,
                      positions: torch.Tensor, rope_theta: float = 10000.0,
                      q_chunk: int = DEFAULT_Q_CHUNK
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal attention over hidden states x: (B, S, d_model) ->
    (out (B, S, d_model), k, v (B, S, KVH, D)); query-chunked above
    ``CHUNK_THRESHOLD`` tokens.  k and v are what a KV cache keeps."""
    q, k, v = project_qkv(params, x, positions, rope_theta)
    if x.shape[1] > CHUNK_THRESHOLD:
        o = chunked_causal_attention(q, k, v, q_chunk)
    else:
        o = causal_attention(q, k, v)
    return output_projection(params, o), k, v


def attention_apply(params: dict, x: torch.Tensor, positions: torch.Tensor,
                    rope_theta: float = 10000.0,
                    q_chunk: int = DEFAULT_Q_CHUNK) -> torch.Tensor:
    """Prefill attention over hidden states x: (B, S, d_model)."""
    return prefill_attention(params, x, positions, rope_theta, q_chunk)[0]


def decode_step_attention(params: dict, x: torch.Tensor,
                          k_cache: torch.Tensor, v_cache: torch.Tensor,
                          cache_len: torch.Tensor,
                          rope_theta: float = 10000.0) -> torch.Tensor:
    """Single-token decode: x (B, d_model) -> (B, d_model).

    The new token's K/V are written into ``k_cache`` / ``v_cache``
    (B, S, KVH, D) IN PLACE at row ``cache_len`` of each batch row, where
    the JAX version returns scattered copies; attention then covers rows
    ``< cache_len + 1`` through the ``flash_decode`` wrapper.
    """
    pos = cache_len.to(torch.int32)
    q, k, v = project_qkv(params, x[:, None], pos[:, None], rope_theta)
    rows = torch.arange(x.shape[0], device=x.device)
    k_cache[rows, pos.long()] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, pos.long()] = v[:, 0].to(v_cache.dtype)
    o = decode_attention(q[:, 0].contiguous(), k_cache, v_cache, pos + 1)
    return output_projection(params, o)
