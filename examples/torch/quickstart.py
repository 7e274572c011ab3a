"""Quickstart on the port: train a TM-GCN dynamic GNN on a synthetic
evolving graph through the declarative ``repro_torch.run`` Engine API.

The twin of ``examples/quickstart.py``: the same model, trace, plan and
seed, and the same three lines.  It runs on the card unless
``--device cpu`` is given:

  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.core import models
from repro_torch.run import Engine, ExecutionPlan, RunConfig, SyntheticTrace


def run(device: str = "cuda", params=None, echo=print) -> dict:
    """Train and evaluate; print the example's lines through ``echo`` and
    return the numbers they show.  ``params``: the initial parameters
    (a ``ParamTree``); drawn from the seed by the port when None."""
    dev = resolve_device(device)
    # 1. Model: 2-layer GCN + M-product (TM-GCN), feature widths per paper
    cfg = models.DynGNNConfig(model="tmgcn", num_nodes=128, num_steps=16,
                              feat_in=2, hidden=6, out_dim=6, window=3,
                              checkpoint_blocks=2)

    # 2. One declarative run: data spec (an evolving graph, smoothed with
    #    the M-transform, paper §5.4) + execution plan (eager schedule,
    #    one device here; shards=P for snapshot partitioning)
    config = RunConfig(
        model=cfg,
        data=SyntheticTrace(num_nodes=128, num_steps=16, density=3.0,
                            churn=0.1, smoothing_mode="mproduct", window=3),
        plan=ExecutionPlan(mode="eager", num_steps=60),
        seed=0, log_fn=echo)

    # 3. Train
    engine = Engine(config, params=params, device=dev)
    result = engine.fit()
    rep = result.transfer_report
    echo(f"graph-difference transfer: {rep['graph_diff']:,} bytes "
         f"vs naive {rep['naive']:,} ({1 / rep['ratio']:.2f}x less)")
    echo(f"loss: {result.losses[0]:.4f} -> {result.losses[-1]:.4f}")

    # 4. Evaluate link prediction on the held-out last snapshot (§6.4)
    acc = engine.evaluate(result)
    echo(f"link-prediction accuracy: {acc:.3f}")
    return {"graph_diff": rep["graph_diff"], "naive": rep["naive"],
            "ratio": rep["ratio"], "losses": list(result.losses),
            "accuracy": acc, "params": result.state.params}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
