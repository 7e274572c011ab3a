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

Over a grid of ranks (a ``dist.sharding.Grid``) each entry point takes a
:class:`Layout` (built from the cell's specs by ``launch.steps``) and this
rank's shards, and computes this rank's part of what the reference's
jitted cell computes on the global batch: rows of the batch over the
data axis; over the model axis a vocab-split embedding (masked local
rows, then an all-reduce) and head (a vocab-parallel log-softmax in each
loss chunk), column-parallel ``wq`` / ``wk`` / ``wv`` and ``wi_gate`` /
``wi_up``, row-parallel ``wo`` and FFN ``wo`` (each followed by an
all-reduce), the MoE's experts or each expert's ``d_ff``
(``nn.moe``), and, where the heads do not divide the axis, each
attention chunk's query rows.  :func:`lm_loss` divides the CE by the
global count of targets and builds the MoE term from global fractions;
:func:`prefill` writes the KV cache in its layout and
:func:`decode_step` returns this rank's logits shard.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.dist import sharding as shd
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


@dataclass(frozen=True)
class Layout:
    """How this rank holds an LM cell on a ``grid`` (a
    ``dist.sharding.Grid``), read off the cell's specs: what the model axis
    splits (``vocab``: the embedding's rows and the head's columns;
    ``heads``: ``wq``'s and ``wo``'s query heads; ``kv_heads``: ``wk``'s and
    ``wv``'s; ``ffn``: ``d_ff``, a dense FFN's or each expert's;
    ``experts``: an MoE's experts; ``seq_chunks``: each attention chunk's
    query rows, when the heads do not divide), whether the data axis
    splits the batch (``batch``), and which axes split the KV cache's rows
    (``kv_seq``: ``""`` none, ``"model"`` or ``"all"``; a cache not split
    by rows is split by KV heads with ``kv_heads``).  Every flag is False
    at model 1, so a 1 x 1 grid runs what no layout runs."""

    grid: Any
    vocab: bool = False
    heads: bool = False
    kv_heads: bool = False
    ffn: bool = False
    experts: bool = False
    seq_chunks: bool = False
    batch: bool = True
    kv_seq: str = ""

    @property
    def model(self):
        """The model row, or None at model 1."""
        return self.grid.model if self.grid.pm > 1 else None

    @property
    def model_index(self) -> int:
        return self.grid.model_index

    @property
    def data(self):
        """The data column, or None at data 1."""
        return self.grid.data if self.grid.pd > 1 else None

    @property
    def route_group(self):
        """The group the MoE routes its tokens over: the data column when
        it splits the batch."""
        return self.data if self.batch else None

    @property
    def expert_group(self):
        """The group an MoE layer's expert work is split over."""
        return self.model if (self.experts or self.ffn) else None

    @property
    def kv_group(self):
        """The group the cache's rows are split over, and this rank's
        slice index in it."""
        if self.kv_seq == "model":
            return self.model, self.grid.model_index
        if self.kv_seq == "all" and self.grid.pd * self.grid.pm > 1:
            return (self.grid.whole or dist.group.WORLD), self.grid.rank
        return None, 0


# ------------------------------------------------------------- params -------

def init_lm_params(gen: torch.Generator, cfg: LMConfig,
                   take=None) -> dict:
    """Random parameters from ``gen``, drawn on its device (the weights of
    a full-size model never pass through the host).  ``take(path, leaf)``
    (a rank's slicing, ``dist.sharding.shard``) is applied to each part as
    it is drawn, so a rank keeps its shards and never holds more than one
    part's whole leaves; the draws are the same either way."""
    l, d, dev = cfg.num_layers, cfg.d_model, gen.device
    vp = cfg.padded_vocab
    keep = take or (lambda _path, x: x)

    def part(prefix: str, tree: dict) -> dict:
        return {k: keep(f"{prefix}.{k}", v) for k, v in tree.items()}

    def norm_w(path, shape):
        fill = torch.zeros if cfg.rms_plus_one else torch.ones
        return keep(path, fill(shape, dtype=cfg.dtype, device=dev))

    if cfg.is_moe:
        ffn = moelib.init_moe(gen, d, cfg.d_ff, cfg.moe_experts, cfg.dtype,
                              lead=(l,))
    else:
        ffn = nnl.init_glu_ffn(gen, d, cfg.d_ff, cfg.dtype, lead=(l,))
    ffn = part("layers.ffn", ffn)
    embed = keep("embed", nnl.normal(gen, (vp, d), 0.02, cfg.dtype))
    attn_p = part("layers.attn", attn.init_attention(
        gen, d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.dtype,
        lead=(l,)))
    return {
        "embed": embed,
        "layers": {
            "attn": attn_p,
            "ffn": ffn,
            "ln1": norm_w("layers.ln1", (l, d)),
            "ln2": norm_w("layers.ln2", (l, d)),
        },
        "final_norm": norm_w("final_norm", (d,)),
        "out": keep("out", nnl.normal(gen, (d, vp), 0.02, cfg.dtype)),
    }


def lm_param_shapes(cfg: LMConfig) -> dict:
    """The shapes of :func:`init_lm_params`' tree, drawn from nothing."""
    l, d, vp = cfg.num_layers, cfg.d_model, cfg.padded_vocab
    h, kvh, hd, ff = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    if cfg.is_moe:
        e = cfg.moe_experts
        ffn = {"router": (l, d, e), "wi_gate": (l, e, d, ff),
               "wi_up": (l, e, d, ff), "wo": (l, e, ff, d)}
    else:
        ffn = {"wi_gate": (l, d, ff), "wi_up": (l, d, ff),
               "wo": (l, ff, d)}
    return {"embed": (vp, d),
            "layers": {"attn": {"wq": (l, d, h, hd), "wk": (l, d, kvh, hd),
                                "wv": (l, d, kvh, hd), "wo": (l, h, hd, d)},
                       "ffn": ffn, "ln1": (l, d), "ln2": (l, d)},
            "final_norm": (d,), "out": (d, vp)}


def layer_params(params: dict, i: int) -> dict:
    """Layer i's slice of the stacked ``params["layers"]`` tree (views)."""
    def pick(tree):
        if isinstance(tree, dict):
            return {k: pick(v) for k, v in tree.items()}
        return tree[i]
    return pick(params["layers"])


# ------------------------------------------------------------ forward -------

def _embed(cfg: LMConfig, params: dict, tokens: torch.Tensor,
           layout: Layout | None = None) -> torch.Tensor:
    table = params["embed"]
    if layout is not None and layout.vocab:
        x = shd.vocab_embedding(table, tokens, layout.model,
                                layout.model_index * table.shape[0])
    else:
        x = table[tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _norm(cfg: LMConfig, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return nnl.rms_norm(x, w, cfg.norm_eps, cfg.rms_plus_one)


def _ffn(cfg: LMConfig, p: dict, h: torch.Tensor,
         layout: Layout | None = None
         ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The block's FFN on h (B, S, d) -> (out, the MoE load-balance loss,
    or None for a dense model); a ``d_ff`` split over the model row takes
    h into the region and all-reduces the row-parallel ``wo``'s sums."""
    if cfg.is_moe:
        out, aux = moelib.moe_apply(p, h, cfg.moe_top_k,
                                    cfg.moe_capacity_factor, cfg.activation,
                                    layout=layout)
        return out, aux["lb_loss"]
    model = layout.model if layout is not None and layout.ffn else None
    out = nnl.glu_ffn_apply(p, shd.copy_to(h, model), cfg.activation)
    return shd.reduce_from(out, model), None


def _block(cfg: LMConfig, lp: dict, x: torch.Tensor,
           positions: torch.Tensor, layout: Layout | None = None):
    """One block over a whole sequence -> (x, k, v, lb): k and v are what
    a KV cache keeps (this rank's KV heads), lb the MoE load-balance loss
    (None if dense)."""
    a, k, v = attn.prefill_attention(lp["attn"], _norm(cfg, x, lp["ln1"]),
                                     positions, cfg.rope_theta, cfg.q_chunk,
                                     layout)
    x = x + a
    f, lb = _ffn(cfg, lp["ffn"], _norm(cfg, x, lp["ln2"]), layout)
    return x + f, k, v, lb


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device)[None, :].expand(b, s)


def forward_hidden(cfg: LMConfig, params: dict, tokens: torch.Tensor,
                   layout: Layout | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (final hidden states (B, S, d), the layers' summed
    MoE load-balance loss (0 for a dense model; over a grid this rank's
    part of it)).  Differentiable; with ``cfg.remat`` and gradients on,
    each layer is recomputed in the backward instead of keeping its
    activations."""
    x = _embed(cfg, params, tokens, layout)
    positions = _positions(tokens)
    lb_sum = torch.zeros((), dtype=torch.float32, device=x.device)

    def layer(lp, x):
        x, _, _, lb = _block(cfg, lp, x, positions, layout)
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
               mask: torch.Tensor, model=None, vocab_start: int = 0
               ) -> torch.Tensor:
    """Summed next-token NLL of one chunk; masked targets add 0.  With
    ``out_w`` this rank's columns ``vocab_start ...`` of a head split over
    the ``model`` row: the log-softmax from the row's max, the sum of
    exps and the target's logit from the rank that holds it."""
    if model is None:
        logp = torch.log_softmax((x @ out_w).to(torch.float32), dim=-1)
        idx = torch.clamp(tgt.long(), 0, logp.shape[-1] - 1)
        nll = -torch.gather(logp, -1, idx[..., None])[..., 0]
        return torch.sum(torch.where(mask, nll, 0.0))
    logits = (shd.copy_to(x, model) @ out_w).to(torch.float32)
    top = shd.all_reduce(logits.detach().amax(dim=-1), model, "tp",
                         op=dist.ReduceOp.MAX)
    sumexp = shd.reduce_from(torch.exp(logits - top[..., None]).sum(-1),
                             model)
    local = tgt.long() - vocab_start
    inside = (local >= 0) & (local < logits.shape[-1])
    picked = torch.gather(logits, -1, torch.clamp(
        local, 0, logits.shape[-1] - 1)[..., None])[..., 0]
    picked = shd.reduce_from(torch.where(inside, picked, 0.0), model)
    nll = torch.log(sumexp) + top - picked
    return torch.sum(torch.where(mask, nll, 0.0))


def lm_loss(cfg: LMConfig, params: dict, tokens: torch.Tensor,
            targets: torch.Tensor, layout: Layout | None = None
            ) -> torch.Tensor:
    """Next-token CE over targets in [0, vocab_size) + aux_loss_weight x
    the MoE load-balance loss / L.

    The head + CE run seq-chunked (``cfg.loss_chunk``, when it divides S
    and is smaller) under checkpoint, so the (B, S, Vp) fp32 logits tensor
    never exists whole.  Over a grid (``layout``) it is this rank's part
    of the global loss, whose sum over the data column is the reference's:
    its rows' CE over the global count of targets, and its part of the MoE
    term (global fractions)."""
    s = tokens.shape[1]
    hidden, lb = forward_hidden(cfg, params, tokens, layout)
    mask = (targets >= 0) & (targets < cfg.vocab_size)
    model = layout.model if layout is not None and layout.vocab else None
    v0 = layout.model_index * params["out"].shape[-1] if model else 0
    c = cfg.loss_chunk
    if c and s % c == 0 and s > c:
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(0, s, c):
            total = total + checkpoint(
                _chunk_nll, params["out"], hidden[:, i:i + c],
                targets[:, i:i + c], mask[:, i:i + c], model, v0,
                use_reentrant=False)
    else:
        total = _chunk_nll(params["out"], hidden, targets, mask, model, v0)
    count = mask.sum()
    if layout is not None:
        count = shd.all_reduce(count, layout.data, "dp")
    ce = total / torch.clamp(count, min=1)
    return ce + cfg.aux_loss_weight * lb / cfg.num_layers


# -------------------------------------------------------------- decode ------

def init_kv_cache(cfg: LMConfig, batch: int, max_len: int,
                  device: torch.device | str) -> dict:
    """{"k", "v": (L, B, max_len, KVH, D) zeros in ``cfg.dtype``,
    "len": (B,) int32}; a rank's share passes its own B, rows and KVH
    through ``cfg`` and the sizes."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


@torch.inference_mode()
def prefill(cfg: LMConfig, params: dict, tokens: torch.Tensor,
            max_len: int, layout: Layout | None = None
            ) -> tuple[torch.Tensor, dict]:
    """Fill a KV cache from a whole prompt; tokens (B, S) ->
    (last-token logits (B, Vp) f32, cache with ``len`` = S).  Attention is
    query-chunked above ``CHUNK_THRESHOLD`` tokens; an MoE layer's capacity
    comes from the B x S prompt tokens.  Over a grid: this rank's rows,
    its vocab columns of the logits, and its share of the cache -- its KV
    heads, or with ``layout.kv_seq == "model"`` its slice of the
    ``max_len`` rows."""
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prefill: prompt of {s} tokens exceeds max_len="
                         f"{max_len}")
    parts, index = (layout.grid.pm, layout.model_index) \
        if layout is not None and layout.kv_seq == "model" else (1, 0)
    rows = max_len // parts
    lo, hi = index * rows, min((index + 1) * rows, s)
    kvh = params["layers"]["attn"]["wk"].shape[2]
    cache = init_kv_cache(dataclasses.replace(cfg, num_kv_heads=kvh), b,
                          rows, device=tokens.device)
    x = _embed(cfg, params, tokens, layout)
    positions = _positions(tokens)
    for i in range(cfg.num_layers):
        x, k, v, _ = _block(cfg, layer_params(params, i), x, positions,
                            layout)
        if hi > lo:
            cache["k"][i, :, :hi - lo] = k[:, lo:hi]
            cache["v"][i, :, :hi - lo] = v[:, lo:hi]
    x = _norm(cfg, x[:, -1], params["final_norm"])
    cache["len"].fill_(s)
    return (x @ params["out"]).to(torch.float32), cache


@torch.inference_mode()
def decode_step(cfg: LMConfig, params: dict, cache: dict,
                token: torch.Tensor, layout: Layout | None = None
                ) -> tuple[torch.Tensor, dict]:
    """One decoding step. token (B,) -> (logits (B, Vp) f32, cache).

    The new token's K/V are written into ``cache["k"]`` / ``["v"]`` in
    place; the returned cache shares them and carries ``len + 1``.  An MoE
    layer routes the B tokens as one (B, 1, d) batch, its capacity from
    T = B, as the reference does.  Over a grid: the rows of the batch this
    rank's cache holds, its share of the cache (``attn
    .decode_step_attention``) and its vocab columns of the logits."""
    x = _embed(cfg, params, token, layout)
    cache_len = cache["len"]
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        h = _norm(cfg, x, lp["ln1"])
        x = x + attn.decode_step_attention(lp["attn"], h, cache["k"][i],
                                           cache["v"][i], cache_len,
                                           cfg.rope_theta, layout)
        f, _ = _ffn(cfg, lp["ffn"], _norm(cfg, x, lp["ln2"])[:, None, :],
                    layout)
        x = x + f[:, 0, :]
    x = _norm(cfg, x, params["final_norm"])
    logits = (x @ params["out"]).to(torch.float32)
    return logits, {"k": cache["k"], "v": cache["v"], "len": cache_len + 1}
