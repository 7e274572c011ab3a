"""Mixture-of-Experts FFN with sort-based top-k dispatch.

Port of ``repro.nn.moe``.  The dispatch is the reference's, step for step:

  1. router logits (fp32) -> softmax -> top-k experts and combine weights
     per token, renormalized over the k picks,
  2. the (token, k) assignments flattened and ordered by expert id with a
     stable sort (the order decides which tokens overflow an expert),
  3. each assignment's position within its expert, clipped to a static
     capacity C = int(cf * T * k / E), at least 8, rounded up to a
     multiple of 8,
  4. tokens gathered into the (E, C, d) expert batch through an
     E * C + 1 slot table whose last row takes the overflow and is cut,
  5. the batched expert GLU-FFN as three ``torch.bmm`` over (E, C, .),
  6. each assignment's expert output gathered back, weighted by its gate
     and summed over the token's k picks.

The reference sums step 6 with ``jax.ops.segment_sum`` over token ids;
every token has exactly k assignments, so the port puts them back in
(token, k) order and sums the k axis (the same sum, with no atomics).
The reference computes all of this outside any Pallas kernel, so the port
leaves it to PyTorch (cuBLAS for the products).

Over a grid of ranks (``layout``, a ``models.lm.Layout``) the layer
computes what the reference's jitted layer computes on the global batch.
Its expert-parallel hook ``ep_constrain`` is ``None`` on every path of
the reference (``repro.dist.sharding.lm_activation_constrainer``); the
port's counterpart is the layout's model group:

* routing is global: each data rank routes its own tokens, all-gathers
  the expert ids over the data group (k ints a token) and orders the
  global assignments as the reference does, so capacity (from the global
  T), which assignments drop and the load-balance fractions are the
  reference's;
* the expert FFN runs on this rank's tokens only (it is row-wise): the
  (E, C, d) batch holds this rank's kept assignments at their global
  slots, the rest zero;
* with E dividing the model axis each model rank holds E / M experts and
  computes their rows; otherwise each expert's ``d_ff`` is split; either
  way the combined output is all-reduced over the model group.
"""

from __future__ import annotations

import torch

from repro_torch.dist import sharding as shd
from repro_torch.nn.layers import ACTIVATIONS, normal


def init_moe(gen: torch.Generator, d_model: int, d_ff: int,
             num_experts: int, dtype=torch.bfloat16,
             lead: tuple[int, ...] = ()) -> dict:
    """router (*lead, d, E) in fp32 (drawn in ``dtype``, as the reference
    does), wi_gate / wi_up (*lead, E, d, ff) and wo (*lead, E, ff, d) in
    ``dtype``; ``lead`` stacks independent draws (the layer axis)."""
    scale = 1.0 / d_model ** 0.5
    e = num_experts
    return {
        "router": normal(gen, lead + (d_model, e), scale, dtype
                         ).to(torch.float32),
        "wi_gate": normal(gen, lead + (e, d_model, d_ff), scale, dtype),
        "wi_up": normal(gen, lead + (e, d_model, d_ff), scale, dtype),
        "wo": normal(gen, lead + (e, d_ff, d_model), 1.0 / d_ff ** 0.5,
                     dtype),
    }


def moe_capacity(tokens: int, top_k: int, num_experts: int,
                 capacity_factor: float) -> int:
    """The static slots an expert: int(cf * T * k / E), at least 8 and a
    multiple of 8."""
    c = int(capacity_factor * tokens * top_k / num_experts)
    return max(8, -(-c // 8) * 8)


def expert_counts(expert_ids: torch.Tensor, num_experts: int
                  ) -> torch.Tensor:
    """Assignments an expert (E,), by ``index_add_``: ``torch.bincount``
    reads the ids' range back to the host on CUDA, two syncs in every MoE
    layer of every step (``scripts/moe_decode_ab.py`` times the two)."""
    return torch.zeros(num_experts, dtype=torch.long,
                       device=expert_ids.device).index_add_(
        0, expert_ids, torch.ones_like(expert_ids))


def moe_apply(params: dict, x: torch.Tensor, top_k: int,
              capacity_factor: float = 1.25, activation: str = "silu",
              capacity: int | None = None, layout=None
              ) -> tuple[torch.Tensor, dict]:
    """x (B, S, d) -> (out (B, S, d), {"lb_loss", "dropped_frac"}).

    Differentiable in x and the parameters (the routing decisions are
    not); assignments past an expert's capacity are dropped.  Over a grid
    (``layout``) x holds this rank's rows, ``params`` its experts (or its
    share of each expert's ``d_ff``); ``lb_loss`` is then this rank's
    part of the global load-balance loss (their sum over the data group
    is the reference's) and ``dropped_frac`` the global fraction."""
    b, s, d = x.shape
    e = params["router"].shape[-1]
    t = b * s
    tokens = x.reshape(t, d)
    dev = x.device
    data = layout.route_group if layout is not None else None
    model = layout.expert_group if layout is not None else None

    logits = tokens.to(torch.float32) @ params["router"]        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)   # (T, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # ---- the global assignments, ordered by expert ------------------------
    n = t * top_k
    flat_expert = expert_idx.reshape(-1)
    everyone = shd.all_gather_dim(flat_expert, data, 0, "dp")
    n_g = everyone.numel()
    t_g = n_g // top_k
    if capacity is None:
        capacity = moe_capacity(t_g, top_k, e, capacity_factor)
    order = torch.sort(everyone, stable=True).indices
    counts = expert_counts(everyone, e)
    expert_start = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(order)
    pos[order] = torch.arange(n_g, device=dev) - expert_start[everyone[order]]
    first = shd.group_rank(data) * n if n_g > n else 0
    pos = pos[first:first + n]                   # this rank's, (token, k)
    keep = pos < capacity

    # ---- gather this rank's kept tokens into the (E, C, d) expert batch ---
    e_local = params["wi_gate"].shape[-3]
    e0 = layout.model_index * e_local if e_local < e else 0
    mine = keep & (flat_expert >= e0) & (flat_expert < e0 + e_local)
    flat_token = torch.arange(t, device=dev)[:, None].expand(
        t, top_k).reshape(-1)
    slot = torch.where(mine, (flat_expert - e0) * capacity + pos,
                       e_local * capacity)
    token_for_slot = torch.zeros(e_local * capacity + 1, dtype=torch.long,
                                 device=dev)
    token_for_slot[slot] = flat_token
    slot_filled = torch.zeros(e_local * capacity + 1, dtype=x.dtype,
                              device=dev)
    slot_filled[slot] = 1.0
    expert_in = shd.copy_to(tokens, model)[token_for_slot[:-1]] \
        * slot_filled[:-1, None]
    expert_in = expert_in.reshape(e_local, capacity, d)

    # ---- expert FFNs -------------------------------------------------------
    act = ACTIVATIONS[activation]
    gate = act(torch.bmm(expert_in, params["wi_gate"]))
    up = torch.bmm(expert_in, params["wi_up"])
    expert_out = torch.bmm(gate * up, params["wo"]).reshape(
        e_local * capacity, d)

    # ---- combine back, in (token, k) order ---------------------------------
    contrib = expert_out[torch.clamp(slot, max=e_local * capacity - 1)]
    weight = shd.copy_to(gate_vals, model).reshape(-1) \
        * mine.to(torch.float32)
    contrib = contrib * weight[:, None].to(contrib.dtype)
    out = contrib.reshape(t, top_k, d).sum(dim=1)
    out = shd.reduce_from(out, model).reshape(b, s, d).to(x.dtype)

    # ---- aux: Switch-style load-balance loss -------------------------------
    frac_tokens = counts.to(torch.float32) / n_g
    frac_probs = probs.mean(dim=0) if n_g == n else probs.sum(dim=0) / t_g
    lb_loss = e * torch.sum(frac_tokens * frac_probs)
    dropped = torch.sum(counts - torch.clamp(counts, max=capacity)).to(
        torch.float32) / n_g
    return out, {"lb_loss": lb_loss, "dropped_frac": dropped}
