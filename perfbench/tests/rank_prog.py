"""The rank program of ``test_perfbench_ranks.py``: one gloo rank of a
4-rank run of the harness on the CPU, optionally with the exchange
between ranks left out of the port's step."""

import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
LIMITS = {"loss": 1e-6, "grad1": 1e-5, "delta3": 1e-5}


def rank_main(rank: int, store: str, model: str, fault: str, q) -> None:
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    import torch.distributed as dist

    from perfbench import harness, judge

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=4, rank=rank)
    judge.load_limits = lambda root, name: LIMITS
    if fault == "no_exchange":
        from repro_torch.train import trainer

        # the gradients' and the loss's all-reduce left out
        trainer.dist = types.SimpleNamespace(
            all_reduce=lambda t, group=None, op=None: None)
    cfg = json.loads((ROOT / "perfbench" / "configs" / f"{model}.json")
                     .read_text())
    traffic = {"nodes": 40, "steps": 16, "edges_per_snapshot": 100,
               "generator": "uniform", "ranks": 4, "lane_multiple": 128}
    res = harness.run(harness.Cell("x", 4, cfg, traffic), 2**33 + 1, 0.2,
                      False, time.time(), "cpu", dist.group.WORLD,
                      log=lambda m: None)
    if rank == 0:
        q.put({"correct": res["correct"], "readings": res["readings"]})
    dist.destroy_process_group()
