"""Online dyngnn serving end to end on the port: train offline, then
serve the trained params against a live CTDG event stream.

The twin of ``examples/serve_dyngnn.py``:

1. discretize a synthetic CTDG and train with ``repro_torch.run.Engine``;
2. stand up a ``ServeEngine`` with the trained params and an
   ``IngestSpec`` matching the training discretization;
3. push the event stream live (chronological chunks), advance the
   resident state window by window, and answer node-scoring +
   link-prediction queries against the warm on-device cache.

  PYTHONPATH=src python examples/torch/serve_dyngnn.py --nodes 64 \
      --windows 16 [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import ctdg
from repro_torch.core.models import DynGNNConfig
from repro_torch.data import dyngnn as dyn_data
from repro_torch.run import Engine, ExecutionPlan, InMemoryDTDG, RunConfig
from repro_torch.serve import IngestSpec, ServeConfig, ServeEngine


def run(nodes: int = 64, windows: int = 16, events: int = 800,
        device: str = "cuda", params=None, echo=print) -> dict:
    """Train, then serve; print the example's lines through ``echo`` and
    return the numbers they show, with the scores and the trained
    parameters.  ``params``: the initial parameters of the training run
    (a ``ParamTree``); drawn from the seed by the port when None."""
    dev = resolve_device(device)
    n, w = nodes, windows

    # -- offline: discretize + train --------------------------------------
    stream = ctdg.synthetic_ctdg(n, events, seed=0)
    snaps = ctdg.snapshot_events(stream, w)
    ds = dyn_data.dataset_from_snapshots(snaps, n, smoothing_mode="none")
    cfg = DynGNNConfig(model="tmgcn", num_nodes=n, num_steps=w, window=3,
                       checkpoint_blocks=2)
    config = RunConfig(model=cfg, data=InMemoryDTDG(ds),
                       plan=ExecutionPlan(mode="streamed", num_epochs=2),
                       seed=0, log_fn=echo)
    fit = Engine(config, params=params, device=dev).fit()
    echo(f"trained: final loss {fit.losses[-1]:.4f}")

    # -- online: serve the trained params against the live stream ---------
    pipe = dyn_data.DTDGPipeline(ds, nb=2, device=dev)
    spec = IngestSpec(
        num_windows=w,
        time_range=(float(stream.time.min()), float(stream.time.max())),
        block_size=pipe.bsize, max_edges=pipe.max_edges)
    eng = ServeEngine(ServeConfig(model=cfg, ingest=spec, seed=0),
                      params=fit.state.params, device=dev)

    ev = stream.sorted()
    chunk = max(len(ev) // 4, 1)
    for lo in range(0, len(ev), chunk):
        sl = slice(lo, lo + chunk)
        eng.ingest(ctdg.EventStream(ev.src[sl], ev.dst[sl], ev.time[sl],
                                    ev.kind[sl], n))
        # advance every window whose events have fully arrived
        arrived = int(spec.window_of(ev.time[sl.stop - 1 if sl.stop
                                             <= len(ev) else -1]))
        while eng.ingester.next_window < min(arrived, w):
            eng.advance()
    eng.advance_all()

    node_scores = eng.query_nodes(np.arange(min(8, n)))
    link_scores = eng.query_links(np.array([[0, 1], [2, 3]]))
    echo(f"node scores {node_scores.shape}, link scores "
         f"{link_scores.shape}")
    res = eng.result()
    echo(res.summary())
    return {"losses": list(fit.losses), "node_scores": node_scores,
            "link_scores": link_scores, "events": res.events_ingested,
            "windows": res.windows_advanced, "resyncs": res.resyncs,
            "queries": res.queries, "query_batches": res.query_batches,
            "block_size": spec.block_size, "max_edges": spec.max_edges,
            "params": fit.state.params}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=64)
    ap.add_argument("--windows", type=int, default=16)
    ap.add_argument("--events", type=int, default=800)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return run(args.nodes, args.windows, args.events, args.device)


if __name__ == "__main__":
    main()
