"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Port of the dyngnn single-device branches of ``repro.launch.train``: it
trains a dynamic-GNN arch (``paper_dyngnn``, ``tmgcn``, ``cdgcn``,
``evolvegcn``) through ``repro_torch.run.Engine`` on a synthetic trace.
By default the blocked trainer runs ``--steps`` steps, evaluates link
prediction and prints the reference's ``done: ...`` line; ``--stream``
runs ``--epochs`` passes of per-snapshot training over the graph-diff
delta stream (the prefetch thread on a side CUDA stream, or inline with
``--no-overlap``) and prints ``streamed ... snapshot steps, final loss
..., transfer ratio ... vs naive``.  ``--device`` defaults to ``cuda``;
``--device cpu`` runs the kernels' plain versions on the host.

The reference's other flags are known by name: each exits with one line
naming the ROADMAP item that ports it (``--stream --mesh P`` with P > 1,
the snapshot-parallel stream, through the plan's refusal).
"""

from __future__ import annotations

import argparse

#: the reference's flags the port does not run yet -> (argparse kwargs,
#: the ROADMAP item that ports them)
_NOT_PORTED = {
    "--data-parallel": ({"type": int, "default": 0}, "Queue 1, item 5"),
    "--mesh": ({"type": int, "default": 0}, "Queue 1, item 5"),
    "--a2a-chunks": ({"type": int, "default": 1}, "Queue 1, item 5"),
    "--pipeline-rounds": ({"action": "store_true"}, "Queue 1, item 7"),
    "--compression": ({"default": "none"}, "Queue 1, item 7"),
    "--rescale-at": ({"action": "append", "default": []},
                     "Queue 1, item 8"),
    "--rescale-on-preempt": ({"type": int, "default": 0},
                             "Queue 1, item 8"),
    "--sampled": ({"action": "store_true"}, "Queue 1, item 8"),
    "--sample-batch": ({"type": int, "default": 0}, "Queue 1, item 8"),
    "--fanout": ({"default": "10,10"}, "Queue 1, item 8"),
    "--device-budget": ({"type": int, "default": 0}, "Queue 1, item 8"),
    "--ckpt-dir": ({"default": None}, "Queue 1, item 8"),
    "--trace": ({"default": None}, "Queue 1, item 8"),
}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (paper-width) config instead of "
                         "the smoke config")
    ap.add_argument("--stream", action="store_true",
                    help="per-snapshot training over the graph-diff delta "
                         "stream instead of the blocked trainer")
    ap.add_argument("--no-overlap", action="store_true",
                    help="--stream: encode and stage inline, without the "
                         "prefetch thread")
    ap.add_argument("--epochs", type=int, default=1,
                    help="--stream: passes over the trace")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu "
                         "(the kernels' plain versions)")
    for flag, (kwargs, _) in _NOT_PORTED.items():
        ap.add_argument(flag, **kwargs, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for flag, (kwargs, item) in _NOT_PORTED.items():
        if flag == "--mesh" and args.stream:
            continue        # the streamed plan names the mesh stream's item
        if getattr(args, flag[2:].replace("-", "_")) != kwargs.get(
                "default", False):
            raise SystemExit(f"{flag} is not ported to PyTorch yet "
                             f"(ROADMAP {item})")

    from repro_torch.configs import registry
    from repro_torch.run import Engine, ExecutionPlan, RunConfig, \
        SyntheticTrace

    arch = registry.get_arch(args.arch)
    if arch.family != "dyngnn":
        raise SystemExit(f"training the {arch.family} family is not ported "
                         "to PyTorch yet (ROADMAP Queue 1, item 9)")
    cfg = (arch.make_config() if args.full_config
           else arch.make_smoke_config())
    smooth = {"tmgcn": "mproduct", "evolvegcn": "edgelife",
              "cdgcn": "none"}[cfg.model]
    data = SyntheticTrace(num_nodes=cfg.num_nodes, num_steps=cfg.num_steps,
                          density=3.0, churn=0.1, smoothing_mode=smooth,
                          window=cfg.window)
    if args.stream:
        plan = ExecutionPlan(
            mode="streamed_mesh" if args.mesh > 1 else "streamed",
            shards=max(args.mesh, 1), num_epochs=args.epochs,
            overlap=not args.no_overlap)
    else:
        plan = ExecutionPlan(mode="eager", num_steps=args.steps)
    try:
        engine = Engine(RunConfig(model=cfg, data=data, plan=plan),
                        device=args.device)
        engine.resolve()
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None
    except ValueError as e:
        raise SystemExit(f"invalid run configuration: {e}") from None
    result = engine.fit()
    final = f"{result.losses[-1]:.4f}" if result.losses else "n/a"
    if args.stream:
        print(f"streamed {result.state.step} snapshot steps, final loss "
              f"{final}, transfer ratio "
              f"{result.transfer_report['ratio']:.3f} vs naive")
        return
    acc = engine.evaluate(result)
    print(f"done: {result.state.step} steps, final loss {final}, "
          f"link-pred acc {acc:.3f}")


if __name__ == "__main__":
    main()
