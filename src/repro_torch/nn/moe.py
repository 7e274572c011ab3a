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
leaves it to PyTorch (cuBLAS for the products).  The expert-parallel
sharding hook ``ep_constrain`` has no counterpart here: expert
parallelism waits for ROADMAP Queue 1, item 9d-2's process groups.
"""

from __future__ import annotations

import torch

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
              capacity: int | None = None
              ) -> tuple[torch.Tensor, dict]:
    """x (B, S, d) -> (out (B, S, d), {"lb_loss", "dropped_frac"}).

    Differentiable in x and the parameters (the routing decisions are
    not); assignments past an expert's capacity are dropped."""
    b, s, d = x.shape
    e = params["router"].shape[-1]
    t = b * s
    tokens = x.reshape(t, d)
    if capacity is None:
        capacity = moe_capacity(t, top_k, e, capacity_factor)
    dev = x.device

    logits = tokens.to(torch.float32) @ params["router"]        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)   # (T, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # ---- flatten (T, k) assignments and order by expert ------------------
    n = t * top_k
    flat_expert = expert_idx.reshape(-1)
    flat_token = torch.arange(t, device=dev)[:, None].expand(
        t, top_k).reshape(-1)
    order = torch.sort(flat_expert, stable=True).indices
    se, st = flat_expert[order], flat_token[order]
    counts = expert_counts(flat_expert, e)
    expert_start = torch.cumsum(counts, 0) - counts
    pos_in_expert = torch.arange(n, device=dev) - expert_start[se]
    keep = pos_in_expert < capacity

    # ---- gather tokens into the (E, C, d) expert batch --------------------
    slot = torch.where(keep, se * capacity + pos_in_expert, e * capacity)
    token_for_slot = torch.zeros(e * capacity + 1, dtype=torch.long,
                                 device=dev)
    token_for_slot[slot] = st
    slot_filled = torch.zeros(e * capacity + 1, dtype=x.dtype, device=dev)
    slot_filled[slot] = 1.0
    expert_in = tokens[token_for_slot[:-1]] * slot_filled[:-1, None]
    expert_in = expert_in.reshape(e, capacity, d)

    # ---- expert FFNs -------------------------------------------------------
    act = ACTIVATIONS[activation]
    gate = act(torch.bmm(expert_in, params["wi_gate"]))
    up = torch.bmm(expert_in, params["wi_up"])
    expert_out = torch.bmm(gate * up, params["wo"]).reshape(e * capacity, d)

    # ---- combine back, in (token, k) order ---------------------------------
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(n, device=dev)
    slot_tk, keep_tk = slot[inverse], keep[inverse]
    contrib = expert_out[torch.clamp(slot_tk, max=e * capacity - 1)]
    weight = gate_vals.reshape(-1) * keep_tk.to(torch.float32)
    contrib = contrib * weight[:, None].to(contrib.dtype)
    out = contrib.reshape(t, top_k, d).sum(dim=1)
    out = out.reshape(b, s, d).to(x.dtype)

    # ---- aux: Switch-style load-balance loss -------------------------------
    frac_tokens = counts.to(torch.float32) / n
    frac_probs = probs.mean(dim=0)
    lb_loss = e * torch.sum(frac_tokens * frac_probs)
    dropped = torch.sum(~keep).to(torch.float32) / n
    return out, {"lb_loss": lb_loss, "dropped_frac": dropped}
