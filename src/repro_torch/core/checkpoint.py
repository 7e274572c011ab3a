"""Timeline-blocked gradient checkpointing (paper §3.1).

Port of ``repro.core.checkpoint``.  The timeline [1..T] is split into
``nb`` blocks of ``bsize = T/nb`` steps.  During the forward pass only the
*carries* pi_b (RNN state at the block boundary + last w-1 windowed
activations) are kept; during backprop each block's forward is re-run.
JAX writes this as ``lax.scan`` over blocks with ``jax.checkpoint`` on the
body; here each block is one ``torch.utils.checkpoint.checkpoint`` call
(non-reentrant) whose inputs and outputs include the carries, so the
gradient reaches the previous block through them.  Memory: one block's
activations plus nb carries.

Non-reentrant checkpointing stops a block's recompute once the last tensor
its backward needs is back (PyTorch's default "early stop"), so the ops
after it — TM-GCN's last-layer M-product, whose backward needs no tensor —
run once per block, not twice.  Every block reads the batch's prebuilt
CSR pairs (``DTDGBatch.csr_pairs``): a recompute builds nothing.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import models as mdl
from repro_torch.core.dtdg import DTDGBatch


def blocked_forward(cfg: mdl.DynGNNConfig, params: mdl.ParamTree,
                    batch: DTDGBatch, nb: int | None = None
                    ) -> torch.Tensor:
    """Embeddings (T, N, out_dim) with blocked checkpointing."""
    nb = nb if nb is not None else cfg.checkpoint_blocks
    t_steps = batch.num_steps
    if t_steps % nb != 0:
        raise ValueError(f"T={t_steps} not divisible by nb={nb}")
    bsize = t_steps // nb
    csrs = batch.csr_pairs()
    carries = mdl.init_carries(cfg, params, dtype=batch.frames.dtype,
                               device=batch.frames.device)
    record = torch.is_grad_enabled()
    zs = []
    for b in range(nb):
        sl = slice(b * bsize, (b + 1) * bsize)
        args = (cfg, params, batch.frames[sl], batch.edges[sl],
                batch.edge_weights[sl], carries, b * bsize, csrs[sl])
        if record:
            z, carries = checkpoint(mdl.forward_slice, *args,
                                    use_reentrant=False)
        else:
            z, carries = mdl.forward_slice(*args)
        zs.append(z)
    return torch.cat(zs)


def blocked_node_loss(cfg: mdl.DynGNNConfig, params: mdl.ParamTree,
                      batch: DTDGBatch, labels: torch.Tensor,
                      nb: int | None = None) -> torch.Tensor:
    z = blocked_forward(cfg, params, batch, nb)
    return mdl.nll_loss(mdl.classify(params, z), labels)


def activation_memory_estimate(cfg: mdl.DynGNNConfig, num_edges: int,
                               nb: int, bytes_per_el: int = 4) -> dict:
    """Analytic per-device activation memory model (paper §3.1 balance).

    intra-block  ~ bsize * (E * (2 idx + w) + N * sum(layer widths))
    checkpoints  ~ nb * |pi|  (RNN state + (w-1)-frame prefix per layer)
    """
    t, n = cfg.num_steps, cfg.num_nodes
    bsize = t // nb
    widths = [d for (_, _, d) in cfg.layer_dims()]
    act_width = sum(widths) + cfg.feat_in
    intra = bsize * (num_edges * (2 * 4 + bytes_per_el)
                     + n * act_width * bytes_per_el)
    pi_width = 0
    for (_, _, d) in cfg.layer_dims():
        if cfg.model == "cdgcn":
            pi_width += 2 * d                      # (h, c)
        elif cfg.model == "tmgcn":
            pi_width += (cfg.window - 1) * d       # frame prefix
        else:                                      # evolvegcn: tiny
            pi_width += 0
    ckpt = nb * n * pi_width * bytes_per_el
    return {"intra_block": intra, "checkpoint": ckpt,
            "total": intra + ckpt, "bsize": bsize}
