"""Decoder-only transformer LM family (yi-6b / gemma-7b / minicpm-2b):
inference.

Port of ``repro.models.lm`` for the dense archs: pre-RMSNorm blocks of GQA
attention + gated FFN, RoPE positions, untied output head.  Layer
parameters keep the JAX package's tree, STACKED on a leading L axis
(``params["layers"]["attn"]["wq"]`` is (L, d, H, D)); a Python loop over
layers takes the place of ``lax.scan``, and the remat / unroll knobs have
no counterpart in inference.  ``prefill`` fills a KV cache
(L, B, max_len, KVH, D) and ``decode_step`` appends one token to it in
place, its attention on the ``flash_decode`` kernel wrapper.  MoE archs
(``moe_experts > 0``) and the training loss wait for later slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.nn import attention as attn
from repro_torch.nn import layers as nnl

_MOE = ("MoE LMs (moe_experts > 0) are not ported to PyTorch yet: ROADMAP "
        "Queue 1, item 9")


@dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 32000
    activation: str = "silu"         # silu = SwiGLU, gelu = GeGLU (gemma)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    rms_plus_one: bool = False       # gemma (1 + w) RMSNorm
    embed_scale: bool = False        # gemma sqrt(d_model) embedding scale
    moe_experts: int = 0             # 0 = dense; MoE is not ported yet
    dtype: torch.dtype = torch.bfloat16
    q_chunk: int = attn.DEFAULT_Q_CHUNK
    lr_schedule: str = "cosine"      # schedule hint (minicpm uses WSD)

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab_size // 256) * 256

    def param_count(self) -> int:
        """Parameters of the dense model (embedding and head padded)."""
        d, l = self.d_model, self.num_layers
        attn_p = d * self.head_dim * (2 * self.num_heads
                                      + 2 * self.num_kv_heads)
        ffn_p = 3 * d * self.d_ff
        return l * (attn_p + ffn_p + 2 * d) + 2 * self.padded_vocab * d + d


def _dense_only(cfg: LMConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError(_MOE)


# ------------------------------------------------------------- params -------

def init_lm_params(gen: torch.Generator, cfg: LMConfig) -> dict:
    """Random parameters from ``gen``, drawn on its device (the weights of
    a full-size model never pass through the host)."""
    _dense_only(cfg)
    l, d, dev = cfg.num_layers, cfg.d_model, gen.device
    vp = cfg.padded_vocab

    def norm_w(shape):
        fill = torch.zeros if cfg.rms_plus_one else torch.ones
        return fill(shape, dtype=cfg.dtype, device=dev)

    return {
        "embed": nnl.normal(gen, (vp, d), 0.02, cfg.dtype),
        "layers": {
            "attn": attn.init_attention(gen, d, cfg.num_heads,
                                        cfg.num_kv_heads, cfg.head_dim,
                                        cfg.dtype, lead=(l,)),
            "ffn": nnl.init_glu_ffn(gen, d, cfg.d_ff, cfg.dtype, lead=(l,)),
            "ln1": norm_w((l, d)),
            "ln2": norm_w((l, d)),
        },
        "final_norm": norm_w((d,)),
        "out": nnl.normal(gen, (d, vp), 0.02, cfg.dtype),
    }


def layer_params(params: dict, i: int) -> dict:
    """Layer i's slice of the stacked ``params["layers"]`` tree (views)."""
    def pick(tree):
        if isinstance(tree, dict):
            return {k: pick(v) for k, v in tree.items()}
        return tree[i]
    return pick(params["layers"])


# ------------------------------------------------------------ forward -------

def _embed(cfg: LMConfig, params: dict, tokens: torch.Tensor
           ) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _norm(cfg: LMConfig, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return nnl.rms_norm(x, w, cfg.norm_eps, cfg.rms_plus_one)


def _prefill_block(cfg: LMConfig, lp: dict, x: torch.Tensor,
                   positions: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block over a whole sequence -> (x, k, v)."""
    a, k, v = attn.prefill_attention(lp["attn"], _norm(cfg, x, lp["ln1"]),
                                     positions, cfg.rope_theta, cfg.q_chunk)
    x = x + a
    h = _norm(cfg, x, lp["ln2"])
    return x + nnl.glu_ffn_apply(lp["ffn"], h, cfg.activation), k, v


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device)[None, :].expand(b, s)


@torch.inference_mode()
def forward(cfg: LMConfig, params: dict, tokens: torch.Tensor
            ) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, Vp) f32.  (The JAX version also
    returns the MoE aux loss, which a dense model has at zero.)"""
    _dense_only(cfg)
    x = _embed(cfg, params, tokens)
    positions = _positions(tokens)
    for i in range(cfg.num_layers):
        x, _, _ = _prefill_block(cfg, layer_params(params, i), x, positions)
    x = _norm(cfg, x, params["final_norm"])
    return (x @ params["out"]).to(torch.float32)


# -------------------------------------------------------------- decode ------

def init_kv_cache(cfg: LMConfig, batch: int, max_len: int,
                  device: torch.device | str) -> dict:
    """{"k", "v": (L, B, max_len, KVH, D) zeros in ``cfg.dtype``,
    "len": (B,) int32}."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


@torch.inference_mode()
def prefill(cfg: LMConfig, params: dict, tokens: torch.Tensor,
            max_len: int) -> tuple[torch.Tensor, dict]:
    """Fill a KV cache from a whole prompt; tokens (B, S) ->
    (last-token logits (B, Vp) f32, cache with ``len`` = S).  Attention is
    query-chunked above ``CHUNK_THRESHOLD`` tokens."""
    _dense_only(cfg)
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prefill: prompt of {s} tokens exceeds max_len="
                         f"{max_len}")
    cache = init_kv_cache(cfg, b, max_len, device=tokens.device)
    x = _embed(cfg, params, tokens)
    positions = _positions(tokens)
    for i in range(cfg.num_layers):
        x, k, v = _prefill_block(cfg, layer_params(params, i), x, positions)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    x = _norm(cfg, x[:, -1], params["final_norm"])
    cache["len"].fill_(s)
    return (x @ params["out"]).to(torch.float32), cache


@torch.inference_mode()
def decode_step(cfg: LMConfig, params: dict, cache: dict,
                token: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One decoding step. token (B,) -> (logits (B, Vp) f32, cache).

    The new token's K/V are written into ``cache["k"]`` / ``["v"]`` in
    place; the returned cache shares them and carries ``len + 1``."""
    _dense_only(cfg)
    x = _embed(cfg, params, token)
    cache_len = cache["len"]
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        h = _norm(cfg, x, lp["ln1"])
        x = x + attn.decode_step_attention(lp["attn"], h, cache["k"][i],
                                           cache["v"][i], cache_len,
                                           cfg.rope_theta)
        h = _norm(cfg, x, lp["ln2"])
        x = x + nnl.glu_ffn_apply(lp["ffn"], h, cfg.activation)
    x = _norm(cfg, x, params["final_norm"])
    logits = (x @ params["out"]).to(torch.float32)
    return logits, {"k": cache["k"], "v": cache["v"], "len": cache_len + 1}
