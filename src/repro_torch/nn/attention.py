"""GQA attention: prefill (full / query-chunked causal) and decode.

Port of ``repro.nn.attention``.  Prefill attention is plain PyTorch
(matmuls, -1e30 masking, fp32 softmax, probabilities cast to q's type
before the PV product), as the JAX package leaves it to XLA; the
query-chunked form bounds the live score tensor to (chunk x S) and is taken
above ``CHUNK_THRESHOLD``.  Decode attention is the ``flash_decode`` kernel
wrapper (``repro_torch.kernels.flash_decode.ops.decode_attention``): the
CUDA kernel for tensors on the card, its plain version on the CPU.  It
computes what ``repro.nn.attention.decode_attention_jnp`` computes.

Over a grid of ranks (``layout``, a ``models.lm.Layout``) prefill
attention runs on this rank's query heads (its KV heads, or all of them
when they do not divide the model axis, taken into the region so their
gradients sum over the row), its output an all-reduce of the row-parallel
``wo``; where the heads do not divide, each query chunk's rows are split
over the model row (the reference's chunk hook) and the chunk's output is
all-gathered.  Decode attention runs on the cache's layout: split by KV
heads, locally; split by rows (over the model row, or over every rank for
``kv_seq_shard``), the rank whose slice holds row ``pos`` writes the new
K/V, every rank runs the kernel on its slice with the whole query, and
the slices merge by their log-sum-exps.
"""

from __future__ import annotations

import torch

from repro_torch.dist import sharding as shd
from repro_torch.kernels.flash_decode.ops import (decode_attention,
                                                  merge_slices)
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
                             q_chunk: int = DEFAULT_Q_CHUNK,
                             rows_over=None) -> torch.Tensor:
    """Causal attention over the query axis in chunks.

    Live memory per chunk: (B, H, q_chunk, S) scores instead of
    (B, H, S, S).  Exact: each chunk sees the full key prefix.

    ``rows_over`` (a process group): the reference's chunk hook -- each
    rank of the group computes its share of every chunk's query rows
    against all keys and the chunk's output is all-gathered.  q, k and v,
    held whole by every rank, enter the region, so their gradients (each
    rank's from its own rows) sum over the group.
    """
    s = q.shape[1]
    if s % q_chunk != 0 or s == q_chunk:
        return causal_attention(q, k, v)
    if rows_over is None:
        return torch.cat([causal_attention(q[:, i:i + q_chunk], k, v,
                                           q_offset=i)
                          for i in range(0, s, q_chunk)], dim=1)
    parts = shd.group_size(rows_over)
    if q_chunk % parts:
        raise ValueError(f"a query chunk of {q_chunk} rows does not split "
                         f"over {parts} ranks")
    w = q_chunk // parts
    r0 = shd.group_rank(rows_over) * w
    q, k, v = (shd.copy_to(t, rows_over) for t in (q, k, v))
    return torch.cat([shd.gather_from(causal_attention(
        q[:, i + r0:i + r0 + w], k, v, q_offset=i + r0), rows_over, dim=1)
        for i in range(0, s, q_chunk)], dim=1)


def project_qkv(params: dict, x: torch.Tensor, positions: torch.Tensor,
                rope_theta: float
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (..., d_model) -> q (..., H, D), k and v (..., KVH, D), RoPE on q
    and k at ``positions`` (the leading dims but the last of x)."""
    q, k, v = (_proj(x, params[n]) for n in ("wq", "wk", "wv"))
    return (apply_rope(q, positions, rope_theta),
            apply_rope(k, positions, rope_theta), v)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d_model) through w (d_model, heads, D) -> (..., heads, D)."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def output_projection(params: dict, o: torch.Tensor) -> torch.Tensor:
    """o (..., H, D) -> (..., d_model) through wo (H, D, d_model)."""
    wo = params["wo"]
    return o.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


def _heads_of(k: torch.Tensor, h0: int, n: int, groups: int
              ) -> torch.Tensor:
    """The KV heads of query heads h0 ... h0 + n - 1 (``groups`` query
    heads a KV head), one a query head: (B, S, n, D)."""
    idx = torch.arange(h0, h0 + n, device=k.device) // groups
    return k.index_select(2, idx)


def prefill_attention(params: dict, x: torch.Tensor,
                      positions: torch.Tensor, rope_theta: float = 10000.0,
                      q_chunk: int = DEFAULT_Q_CHUNK, layout=None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal attention over hidden states x: (B, S, d_model) ->
    (out (B, S, d_model), k, v (B, S, KVH, D)); query-chunked above
    ``CHUNK_THRESHOLD`` tokens.  k and v are what a KV cache keeps (over
    a grid this rank's KV heads: all of them when they are not split)."""
    model = layout.model if layout is not None else None
    chunked = x.shape[1] > CHUNK_THRESHOLD
    if model is not None and layout.heads:
        xt = shd.copy_to(x, model)
        # KV weights held whole are used for this rank's heads alone: they
        # project the whole x, and k and v enter the region instead
        src = xt if layout.kv_heads else x
        q = apply_rope(_proj(xt, params["wq"]), positions, rope_theta)
        k = apply_rope(_proj(src, params["wk"]), positions, rope_theta)
        v = _proj(src, params["wv"])
        if layout.kv_heads:
            kq, vq = k, v
        else:
            hl = q.shape[2]
            groups = hl * layout.grid.pm // k.shape[2]
            h0 = layout.model_index * hl
            kq = _heads_of(shd.copy_to(k, model), h0, hl, groups)
            vq = _heads_of(shd.copy_to(v, model), h0, hl, groups)
        o = (chunked_causal_attention(q, kq, vq, q_chunk) if chunked
             else causal_attention(q, kq, vq))
        return shd.reduce_from(output_projection(params, o), model), k, v
    q, k, v = project_qkv(params, x, positions, rope_theta)
    if model is not None and layout.seq_chunks:
        o = chunked_causal_attention(q, k, v, q_chunk, rows_over=model)
    elif chunked:
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
                          rope_theta: float = 10000.0,
                          layout=None) -> torch.Tensor:
    """Single-token decode: x (B, d_model) -> (B, d_model).

    The new token's K/V are written into ``k_cache`` / ``v_cache``
    (B, S, KVH, D) IN PLACE at row ``cache_len`` of each batch row, where
    the JAX version returns scattered copies; attention then covers rows
    ``< cache_len + 1`` through the ``flash_decode`` wrapper.

    Over a grid the cache is this rank's share: its KV heads (attention
    runs locally on its query heads), or with ``layout.kv_seq`` its slice
    of S rows, ``cache_len`` global: the rank whose slice holds row
    ``cache_len`` writes the new K/V there (all KV heads, RoPE at the
    global position), the (B, Hq, D) queries are all-gathered over the
    model row when their heads are split, the kernel runs on the slice
    with the length clamped to it and returns its log-sum-exp, and the
    slices' outputs merge by it over the group the rows are split over
    (``merge_slices``; an empty slice weighs 0).  Each rank's query heads
    then go through its ``wo`` shard, all-reduced over the model row.
    """
    pos = cache_len.to(torch.int32)
    model = layout.model if layout is not None else None
    group, index = layout.kv_group if layout is not None else (None, 0)
    q, k, v = project_qkv(params, x[:, None], pos[:, None], rope_theta)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    rows = torch.arange(x.shape[0], device=x.device)
    if group is None:
        k_cache[rows, pos.long()] = k.to(k_cache.dtype)
        v_cache[rows, pos.long()] = v.to(v_cache.dtype)
        o = decode_attention(q.contiguous(), k_cache, v_cache, pos + 1)
    else:
        if layout.kv_heads:
            k = shd.all_gather_dim(k, model, 1, "tp")
            v = shd.all_gather_dim(v, model, 1, "tp")
        n = k_cache.shape[1]
        local = pos.long() - index * n
        mine = ((local >= 0) & (local < n))[:, None, None]
        at = torch.clamp(local, 0, n - 1)
        k_cache[rows, at] = torch.where(mine, k.to(k_cache.dtype),
                                        k_cache[rows, at])
        v_cache[rows, at] = torch.where(mine, v.to(v_cache.dtype),
                                        v_cache[rows, at])
        q_all = shd.all_gather_dim(q, model, 1, "tp") if layout.heads \
            else q
        o, lse = decode_attention(
            q_all.contiguous(), k_cache, v_cache,
            torch.clamp(pos + 1 - index * n, 0, n).to(torch.int32),
            return_lse=True)
        both = torch.cat([o.to(torch.float32), lse[..., None]], dim=-1)
        both = shd.all_gather_dim(both[None], group, 0, "cp")
        o = merge_slices(both[..., :-1], both[..., -1]).to(q.dtype)
        if layout.heads:
            hl = q.shape[1]
            o = o[:, layout.model_index * hl:(layout.model_index + 1) * hl]
    out = output_projection(params, o)
    return shd.reduce_from(out, model) if layout is not None \
        and layout.heads else out
