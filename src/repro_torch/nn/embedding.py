"""Sparse embedding substrate for recsys: EmbeddingBag from a row gather
plus a masked or segmented reduction.

Port of ``repro.nn.embedding``: ``jnp.take`` becomes ``F.embedding`` (a
row gather whose gradient is a dense scatter-add into the table) and
``jax.ops.segment_sum`` becomes ``index_add``.  The semantics are the
reference's: ``mean`` divides by ``max(count, 1)``; ``max`` fills masked
slots with -1e30 and returns 0 for a bag with no valid slot.  One
difference: ``jnp.take`` fills NaN for an id at or past the vocabulary,
where the gather here raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.layers import normal


def init_table(gen: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32) -> torch.Tensor:
    """(vocab, dim) with N(0, 0.01^2) entries, on ``gen``'s device."""
    return normal(gen, (vocab, dim), 0.01, dtype)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor
                     ) -> torch.Tensor:
    """Plain lookup: ids (...,) int -> (..., dim)."""
    return F.embedding(ids, table)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  offsets_or_mask: torch.Tensor, mode: str = "sum"
                  ) -> torch.Tensor:
    """Bagged lookup over a padded (B, L) id matrix with a validity mask.

    Equivalent to ``torch.nn.EmbeddingBag`` on padded bags:
      out[b] = reduce_{l: mask[b,l]>0} table[ids[b,l]]
    """
    emb = F.embedding(ids, table)                           # (B, L, D)
    mask = offsets_or_mask.to(emb.dtype)
    if mode == "sum":
        return torch.sum(emb * mask[..., None], dim=1)
    if mode == "mean":
        cnt = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
        return torch.sum(emb * mask[..., None], dim=1) / cnt
    if mode == "max":
        neg = torch.where(mask[..., None] > 0, emb,
                          torch.full_like(emb, -1e30))
        # amax splits the gradient evenly over ties, as jnp.max does
        out = torch.amax(neg, dim=1)
        return torch.where(out <= -1e29, torch.zeros_like(out), out)
    raise ValueError(mode)


def embedding_bag_segment(table: torch.Tensor, flat_ids: torch.Tensor,
                          segment_ids: torch.Tensor, num_bags: int,
                          weights: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Ragged EmbeddingBag: flat ids + segment ids (CSR-style bags) ->
    (num_bags, dim), each row the (weighted) sum of its bag."""
    emb = F.embedding(flat_ids, table)
    if weights is not None:
        emb = emb * weights[:, None].to(emb.dtype)
    return emb.new_zeros((num_bags, emb.shape[-1])).index_add(
        0, segment_ids.long(), emb)
