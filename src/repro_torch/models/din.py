"""DIN — Deep Interest Network (arXiv:1706.06978).

Port of ``repro.models.din``.  Config: embed_dim=18, user-history
seq_len=100, attention MLP 80-40, final MLP 200-80, target attention
interaction.

Structure: sparse id features -> embeddings; the user's behaviour history
(item ids + category ids) is pooled by TARGET ATTENTION — a small MLP scores
each history item against the candidate ad:

    a_l = MLP([h_l, t, h_l - t, h_l * t])      (80 -> 40 -> 1)
    u   = sum_l a_l * h_l                      (no softmax, per the paper)

then concat(user emb, pooled interest, target emb) -> MLP -> CTR logit.
``params`` is the reference's tree (``item_table``, ``cate_table``,
``user_table``, the ``attn_mlp`` and ``mlp`` lists), as nested dicts or a
``ParamTree``; load the reference's numbers with
``repro_torch.convert.din_params_from_jax``.

``score_candidates`` serves the retrieval_cand shape: one user history
scored against N candidates by broadcasting the user tensors.  Its
``chunk`` scores the candidates that many at a time (the reference splits
them over its data-parallel devices; one card cannot hold the (N, L, 4P)
features of N = 1,000,000, so a rank scores its candidates in chunks
too).

Over a grid (:class:`Layout`: the reference's cell with
``din_param_specs``) the three tables are split by vocab rows over the
grid's model row and every lookup is ``dist.sharding.vocab_embedding``
(the rank's rows, then a sum over the row); a rank's batch rows are its
data rank's, and ``ctr_loss`` is its rows' share of the mean over the
global batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.dist import sharding as shd
from repro_torch.nn.embedding import embedding_lookup, init_table
from repro_torch.nn.layers import init_mlp, mlp_apply


@dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    embed_dim: int = 18
    seq_len: int = 100
    attn_hidden: tuple = (80, 40)
    mlp_hidden: tuple = (200, 80)
    item_vocab: int = 1_000_000
    cate_vocab: int = 10_000
    user_vocab: int = 1_000_000
    num_classes: int = 2


@dataclass(frozen=True)
class Layout:
    """A rank's part of DIN over ``grid``: ``vocab`` the tables split by
    rows over the model row (this rank's rows from ``model_index x`` its
    rows), ``batch`` the global batch ``ctr_loss`` averages over."""

    grid: Any
    vocab: bool = False
    batch: int = 0


def _lookup(table: torch.Tensor, ids: torch.Tensor,
            layout: Layout | None) -> torch.Tensor:
    if layout is None or not layout.vocab:
        return embedding_lookup(table, ids)
    return shd.vocab_embedding(table, ids, layout.grid.model,
                               layout.grid.model_index * table.shape[0])


def init_params(gen: torch.Generator, cfg: DINConfig,
                dtype=torch.float32) -> dict:
    """Fresh parameters drawn from ``gen`` on its device (the reference's
    tree and distributions, not its numbers)."""
    d = cfg.embed_dim
    # history/target features are (item, category) pairs -> 2d wide
    pair = 2 * d
    attn_dims = [4 * pair, *cfg.attn_hidden, 1]
    mlp_in = d + pair + pair          # user + pooled interest + target
    mlp_dims = [mlp_in, *cfg.mlp_hidden, cfg.num_classes]
    return {
        "item_table": init_table(gen, cfg.item_vocab, d, dtype),
        "cate_table": init_table(gen, cfg.cate_vocab, d, dtype),
        "user_table": init_table(gen, cfg.user_vocab, d, dtype),
        "attn_mlp": init_mlp(gen, attn_dims, dtype),
        "mlp": init_mlp(gen, mlp_dims, dtype),
    }


def _pair_embed(params, item_ids: torch.Tensor, cate_ids: torch.Tensor,
                layout: Layout | None = None) -> torch.Tensor:
    it = _lookup(params["item_table"], item_ids, layout)
    ct = _lookup(params["cate_table"], cate_ids, layout)
    return torch.cat([it, ct], dim=-1)


def target_attention(params, hist: torch.Tensor, hist_mask: torch.Tensor,
                     target: torch.Tensor) -> torch.Tensor:
    """hist (B, L, P); target (B, P) -> pooled interest (B, P)."""
    t = target[:, None, :].expand_as(hist)
    feat = torch.cat([hist, t, hist - t, hist * t], dim=-1)
    scores = mlp_apply(params["attn_mlp"], feat, activation="relu")[..., 0]
    scores = scores * hist_mask.to(scores.dtype)            # (B, L)
    return torch.einsum("bl,blp->bp", scores, hist)


def forward(params, batch: dict, layout: Layout | None = None
            ) -> torch.Tensor:
    """batch: user_id (B,), hist_items/hist_cates (B, L), hist_mask (B, L),
    target_item/target_cate (B,) -> logits (B, C)."""
    hist = _pair_embed(params, batch["hist_items"], batch["hist_cates"],
                       layout)
    target = _pair_embed(params, batch["target_item"], batch["target_cate"],
                         layout)
    user = _lookup(params["user_table"], batch["user_id"], layout)
    interest = target_attention(params, hist, batch["hist_mask"], target)
    x = torch.cat([user, interest, target], dim=-1)
    return mlp_apply(params["mlp"], x, activation="relu")


def ctr_loss(params, batch: dict, labels: torch.Tensor,
             layout: Layout | None = None) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` (B,) under the logits
    (with ``layout``: these rows' share of the mean over
    ``layout.batch``)."""
    logits = forward(params, batch, layout)
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if layout is not None:
        return torch.sum(nll) / layout.batch
    return torch.mean(nll)


def score_candidates(params, batch: dict, cand_items: torch.Tensor,
                     cand_cates: torch.Tensor, chunk: int | None = None,
                     layout: Layout | None = None) -> torch.Tensor:
    """Retrieval scoring: ONE user vs N candidates (retrieval_cand shape).

    batch: single-user history (1, L); cand_*: (N,).  The history embedding
    and user embedding are computed once; the per-candidate target attention
    broadcasts over the candidates.  Returns (N,) CTR scores.  ``chunk``
    scores ``chunk`` candidates at a time (the features of a chunk are
    (chunk, L, 4P)); each chunk's scores are those rows of the unchunked
    call.  Run it under ``torch.no_grad()`` to free each chunk's
    intermediates before the next.
    """
    hist = _pair_embed(params, batch["hist_items"], batch["hist_cates"],
                       layout)
    hist = hist[0]                                        # (L, P)
    mask = batch["hist_mask"][0]                          # (L,)
    user = _lookup(params["user_table"], batch["user_id"], layout)[0]

    def score(items: torch.Tensor, cates: torch.Tensor) -> torch.Tensor:
        targets = _pair_embed(params, items, cates, layout)  # (n, P)
        n = targets.shape[0]
        t = targets[:, None, :].expand(n, *hist.shape)     # (n, L, P)
        h = hist[None].expand_as(t)
        feat = torch.cat([h, t, h - t, h * t], dim=-1)
        scores = mlp_apply(params["attn_mlp"], feat,
                           activation="relu")[..., 0]
        scores = scores * mask[None, :].to(scores.dtype)   # (n, L)
        interest = scores @ hist                           # (n, P)
        x = torch.cat([user[None].expand(n, -1), interest, targets], dim=-1)
        logits = mlp_apply(params["mlp"], x, activation="relu")
        return torch.softmax(logits, dim=-1)[:, 1]

    if chunk is None:
        return score(cand_items, cand_cates)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return torch.cat([score(cand_items[i:i + chunk], cand_cates[i:i + chunk])
                      for i in range(0, cand_items.shape[0], chunk)])


def synthetic_requests(rng: np.random.Generator, cfg: DINConfig,
                       batch_size: int) -> dict:
    """One synthetic CTR request batch as numpy arrays, drawn from ``rng``
    in the reference engine's order (user, hist_items, hist_cates,
    target_item, target_cate); the mask is all ones."""
    b, s = batch_size, cfg.seq_len
    ints = rng.integers
    user = ints(0, cfg.user_vocab, (b,))
    hist_items = ints(0, cfg.item_vocab, (b, s))
    hist_cates = ints(0, cfg.cate_vocab, (b, s))
    target_item = ints(0, cfg.item_vocab, (b,))
    target_cate = ints(0, cfg.cate_vocab, (b,))
    return {"user_id": user.astype(np.int32),
            "hist_items": hist_items.astype(np.int32),
            "hist_cates": hist_cates.astype(np.int32),
            "hist_mask": np.ones((b, s), np.float32),
            "target_item": target_item.astype(np.int32),
            "target_cate": target_cate.astype(np.int32)}


def batch_to(arrays: dict, device: str | torch.device = "cpu") -> dict:
    """A batch of numpy arrays -> tensors on ``device`` (ids int32, the
    mask float32)."""
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}
