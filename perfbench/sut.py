"""The system under test: the port's eager dyngnn train step on this
rank, fed with the cell's inputs.

The step is the one ``repro_torch.run.workers.fit_eager`` runs, called as
it calls it: ``train.trainer.make_single_device_train_step(cfg, opt_cfg)
(params, opt_state, batch, labels)`` on one card (the batch a
``core.dtdg.DTDGBatch`` whose ``csr_pairs()`` are built once, in set-up),
or on a process group ``train.trainer.make_dyngnn_train_step(cfg, group,
opt_cfg)`` over the rank's blocked arrays with ``csrs=`` the rank's CSR
pairs (float32 payloads, no fused final layer: the Engine's settings).
The Laplacian weights are the port's (``graph.segment.gcn_edge_weights``,
what ``core.dtdg.build_batch`` calls); snapshots, features, labels and the
initial parameters are the benchmark's (``perfbench.gen``).
"""

from __future__ import annotations

import torch

from perfbench import gen


def opt_fields(cfg: dict) -> dict:
    """The AdamW settings of a configuration, as ``AdamWConfig`` fields."""
    o = cfg["optimizer"]
    return {k: o[k] for k in ("lr", "b1", "b2", "eps", "weight_decay",
                              "grad_clip", "warmup_steps", "total_steps",
                              "schedule", "min_lr_frac")}


class Program:
    """The port's step with its parameters, AdamW state and inputs on this
    rank; ``group`` is the process group of a cell over ranks (None: one
    card)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 params0: dict[str, torch.Tensor], device, group=None):
        from repro_torch.core import models as dyn
        from repro_torch.core.dtdg import DTDGBatch
        from repro_torch.dist.sharding import ShardLayout
        from repro_torch.graph import segment
        from repro_torch.optim import adamw
        from repro_torch.train import trainer

        n, t_steps = traffic["nodes"], traffic["steps"]
        nb = cfg["checkpoint_blocks"]
        self.cfg = dyn.DynGNNConfig(
            model=cfg["model"], num_nodes=n, num_steps=t_steps,
            feat_in=cfg["feat_in"], hidden=cfg["hidden"],
            out_dim=cfg["out_dim"], num_layers=cfg["num_layers"],
            window=cfg["window"], num_classes=cfg["num_classes"],
            checkpoint_blocks=nb)
        self.opt_cfg = adamw.AdamWConfig(**opt_fields(cfg))
        if group is None:
            steps = list(range(t_steps))
        else:
            layout = ShardLayout.of(group, nb, t_steps // nb, n)
            steps = layout.steps
        e_pad = gen.lanes(traffic)
        k = len(steps)
        edges = torch.empty((k, e_pad, 2), dtype=torch.int32, device=device)
        mask = torch.empty((k, e_pad), dtype=torch.float32, device=device)
        weights = torch.empty((k, e_pad), dtype=torch.float32,
                              device=device)
        frames = torch.empty((k, n, cfg["feat_in"]), dtype=torch.float32,
                             device=device)
        labels = torch.empty((k, n), dtype=torch.int32, device=device)
        for i, t in enumerate(steps):
            raw = gen.raw_edges(seed, t, traffic, device)
            edges[i], mask[i] = gen.padded_lanes(raw, traffic)
            frames[i], labels[i] = gen.features_and_labels(raw, n)
            # unit edge values on the real lanes, as build_batch pads them
            weights[i] = segment.gcn_edge_weights(edges[i], n, mask[i],
                                                  mask[i])
            del raw
        self.batch = DTDGBatch(edges=edges, edge_weights=weights,
                               edge_mask=mask, frames=frames, num_nodes=n)
        params = dyn.init_params(torch.Generator().manual_seed(0),
                                 self.cfg).to(device)
        named = dict(params.named_parameters())
        if set(named) != set(params0) or any(
                named[k].shape != params0[k].shape for k in named):
            def shapes(tree):
                return sorted((k, tuple(v.shape)) for k, v in tree.items())

            raise ValueError(f"the port's parameters {shapes(named)} are not "
                             f"the benchmark's {shapes(params0)}")
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(params0[k])
        self.params = params
        self.opt_state = adamw.init_state(params)
        if group is None:
            self.fn = trainer.make_single_device_train_step(self.cfg,
                                                            self.opt_cfg)
            self.args = (self.batch, labels)
        else:
            bsl = len(steps) // nb
            self.fn = trainer.make_dyngnn_train_step(self.cfg, group,
                                                     self.opt_cfg)
            self.args = tuple(a.reshape((nb, bsl) + tuple(a.shape[1:]))
                              for a in (frames, edges, weights, labels))
        self.kwargs = {}
        self.group = group

    def build_csrs(self) -> None:
        """The rank's CSR pairs, once (``DTDGBatch.csr_pairs``: the fenced
        ``train.csr_build`` span)."""
        csrs = self.batch.csr_pairs()
        if self.group is not None:
            self.kwargs = {"csrs": csrs}

    def step(self) -> float:
        """One train step -> its loss, read as the worker reads it."""
        self.params, self.opt_state, loss = self.fn(
            self.params, self.opt_state, *self.args, **self.kwargs)
        return float(loss)

    def first_gradient(self) -> dict[str, torch.Tensor]:
        """The gradient the optimizer took at its first step, from its
        state after that step: m_1 / (1 - b1) (clipped, as AdamW used it)."""
        b1 = self.opt_cfg.b1
        return {k: v.detach().clone() / (1 - b1)
                for k, v in self.opt_state["m"].items()}

    def parameters(self) -> dict[str, torch.Tensor]:
        return {k: p.detach().clone()
                for k, p in self.params.named_parameters()}
