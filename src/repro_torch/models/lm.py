"""Decoder-only transformer LM family (yi-6b / gemma-7b / minicpm-2b /
olmoe-1b-7b / moonshot-v1-16b-a3b): serving and training.

Port of ``repro.models.lm``: pre-RMSNorm blocks of GQA attention + gated
FFN (dense GLU, or the MoE of ``repro_torch.nn.moe`` when ``moe_experts >
0``), RoPE positions, untied output head.  Layer parameters keep the JAX
package's tree, STACKED on a leading L axis (``params["layers"]["attn"]
["wq"]`` is (L, d, H, D)); a Python loop over layers takes the place of
``lax.scan``.  :func:`forward_hidden` is the differentiable forward;
``remat=True`` checkpoints each layer with ``torch.utils.checkpoint`` when
gradients are being taken (the reference's per-layer ``jax.checkpoint``).
The reference's ``layer_block``, ``layer_unroll`` and ``unroll_chunks``
only shape XLA's graph (two-level remat groups, scan unrolling for cost
extraction) and have no counterpart.  :func:`lm_loss` is next-token
cross-entropy plus the MoE load-balance term, its head + CE chunked by
``loss_chunk`` under checkpoint so the (B, S, Vp) fp32 logits never exist
whole.  The serving entry points (:func:`forward`, :func:`prefill`,
:func:`decode_step`) run under ``torch.inference_mode``; ``prefill`` fills
a KV cache (L, B, max_len, KVH, D) and ``decode_step`` appends one token
to it in place, its attention on the ``flash_decode`` kernel wrapper.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.nn import attention as attn
from repro_torch.nn import layers as nnl
from repro_torch.nn import moe as moelib


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
    # MoE (0 experts = dense)
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # execution
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True               # per-layer checkpoint under autograd
    q_chunk: int = attn.DEFAULT_Q_CHUNK
    # chunk the CE loss over the sequence; 0 = unchunked
    loss_chunk: int = 1024
    lr_schedule: str = "cosine"      # schedule hint (minicpm uses WSD)

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab_size // 256) * 256

    def _attn_params(self) -> int:
        return self.d_model * self.head_dim * (2 * self.num_heads
                                               + 2 * self.num_kv_heads)

    def _count(self, ffn_p: int) -> int:
        d, l = self.d_model, self.num_layers
        embed = 2 * self.padded_vocab * d
        return l * (self._attn_params() + ffn_p + 2 * d) + embed + d

    def param_count(self) -> int:
        """Parameters (embedding and head padded; MoE: every expert and
        the router)."""
        d = self.d_model
        if self.is_moe:
            return self._count(self.moe_experts * 3 * d * self.d_ff
                               + d * self.moe_experts)
        return self._count(3 * d * self.d_ff)

    def active_param_count(self) -> int:
        """Activated params per token (MoE counts top_k experts only)."""
        if not self.is_moe:
            return self.param_count()
        return self._count(self.moe_top_k * 3 * self.d_model * self.d_ff)


# ------------------------------------------------------------- params -------

def init_lm_params(gen: torch.Generator, cfg: LMConfig) -> dict:
    """Random parameters from ``gen``, drawn on its device (the weights of
    a full-size model never pass through the host)."""
    l, d, dev = cfg.num_layers, cfg.d_model, gen.device
    vp = cfg.padded_vocab

    def norm_w(shape):
        fill = torch.zeros if cfg.rms_plus_one else torch.ones
        return fill(shape, dtype=cfg.dtype, device=dev)

    if cfg.is_moe:
        ffn = moelib.init_moe(gen, d, cfg.d_ff, cfg.moe_experts, cfg.dtype,
                              lead=(l,))
    else:
        ffn = nnl.init_glu_ffn(gen, d, cfg.d_ff, cfg.dtype, lead=(l,))
    return {
        "embed": nnl.normal(gen, (vp, d), 0.02, cfg.dtype),
        "layers": {
            "attn": attn.init_attention(gen, d, cfg.num_heads,
                                        cfg.num_kv_heads, cfg.head_dim,
                                        cfg.dtype, lead=(l,)),
            "ffn": ffn,
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


def _ffn(cfg: LMConfig, p: dict, h: torch.Tensor
         ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The block's FFN on h (B, S, d) -> (out, the MoE load-balance loss,
    or None for a dense model)."""
    if cfg.is_moe:
        out, aux = moelib.moe_apply(p, h, cfg.moe_top_k,
                                    cfg.moe_capacity_factor, cfg.activation)
        return out, aux["lb_loss"]
    return nnl.glu_ffn_apply(p, h, cfg.activation), None


def _block(cfg: LMConfig, lp: dict, x: torch.Tensor,
           positions: torch.Tensor):
    """One block over a whole sequence -> (x, k, v, lb): k and v are what
    a KV cache keeps, lb the MoE load-balance loss (None if dense)."""
    a, k, v = attn.prefill_attention(lp["attn"], _norm(cfg, x, lp["ln1"]),
                                     positions, cfg.rope_theta, cfg.q_chunk)
    x = x + a
    f, lb = _ffn(cfg, lp["ffn"], _norm(cfg, x, lp["ln2"]))
    return x + f, k, v, lb


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device)[None, :].expand(b, s)


def forward_hidden(cfg: LMConfig, params: dict, tokens: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (final hidden states (B, S, d), the layers' summed
    MoE load-balance loss (0 for a dense model)).  Differentiable; with
    ``cfg.remat`` and gradients on, each layer is recomputed in the
    backward instead of keeping its activations."""
    x = _embed(cfg, params, tokens)
    positions = _positions(tokens)
    lb_sum = torch.zeros((), dtype=torch.float32, device=x.device)

    def layer(lp, x):
        x, _, _, lb = _block(cfg, lp, x, positions)
        return x, (lb if lb is not None else torch.zeros_like(lb_sum))

    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        if remat:
            x, lb = checkpoint(layer, lp, x, use_reentrant=False)
        else:
            x, lb = layer(lp, x)
        lb_sum = lb_sum + lb
    return _norm(cfg, x, params["final_norm"]), lb_sum


@torch.inference_mode()
def forward(cfg: LMConfig, params: dict, tokens: torch.Tensor
            ) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, Vp) f32.  (The JAX version also
    returns the MoE aux loss: :func:`forward_hidden` gives it.)"""
    x, _ = forward_hidden(cfg, params, tokens)
    return (x @ params["out"]).to(torch.float32)


def _chunk_nll(out_w: torch.Tensor, x: torch.Tensor, tgt: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Summed next-token NLL of one chunk; masked targets add 0."""
    logp = torch.log_softmax((x @ out_w).to(torch.float32), dim=-1)
    idx = torch.clamp(tgt.long(), 0, logp.shape[-1] - 1)
    nll = -torch.gather(logp, -1, idx[..., None])[..., 0]
    return torch.sum(torch.where(mask, nll, 0.0))


def lm_loss(cfg: LMConfig, params: dict, tokens: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    """Next-token CE over targets in [0, vocab_size) + aux_loss_weight x
    the MoE load-balance loss / L.

    The head + CE run seq-chunked (``cfg.loss_chunk``, when it divides S
    and is smaller) under checkpoint, so the (B, S, Vp) fp32 logits tensor
    never exists whole."""
    s = tokens.shape[1]
    hidden, lb = forward_hidden(cfg, params, tokens)
    mask = (targets >= 0) & (targets < cfg.vocab_size)
    c = cfg.loss_chunk
    if c and s % c == 0 and s > c:
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(0, s, c):
            total = total + checkpoint(
                _chunk_nll, params["out"], hidden[:, i:i + c],
                targets[:, i:i + c], mask[:, i:i + c], use_reentrant=False)
    else:
        total = _chunk_nll(params["out"], hidden, targets, mask)
    ce = total / torch.clamp(mask.sum(), min=1)
    return ce + cfg.aux_loss_weight * lb / cfg.num_layers


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
    query-chunked above ``CHUNK_THRESHOLD`` tokens; an MoE layer's capacity
    comes from the B x S prompt tokens."""
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prefill: prompt of {s} tokens exceeds max_len="
                         f"{max_len}")
    cache = init_kv_cache(cfg, b, max_len, device=tokens.device)
    x = _embed(cfg, params, tokens)
    positions = _positions(tokens)
    for i in range(cfg.num_layers):
        x, k, v, _ = _block(cfg, layer_params(params, i), x, positions)
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
    place; the returned cache shares them and carries ``len + 1``.  An MoE
    layer routes the B tokens as one (B, 1, d) batch, its capacity from
    T = B, as the reference does."""
    x = _embed(cfg, params, token)
    cache_len = cache["len"]
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        h = _norm(cfg, x, lp["ln1"])
        x = x + attn.decode_step_attention(lp["attn"], h, cache["k"][i],
                                           cache["v"][i], cache_len,
                                           cfg.rope_theta)
        f, _ = _ffn(cfg, lp["ffn"], _norm(cfg, x, lp["ln2"])[:, None, :])
        x = x + f[:, 0, :]
    x = _norm(cfg, x, params["final_norm"])
    logits = (x @ params["out"]).to(torch.float32)
    return logits, {"k": cache["k"], "v": cache["v"], "len": cache_len + 1}
