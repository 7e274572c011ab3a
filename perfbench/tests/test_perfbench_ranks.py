"""A run over 4 ranks (gloo on the CPU, the harness's 4-chip path): the
port's snapshot-partitioned step against the reference, and the same run
with the exchange between ranks left out coming out not correct."""

import multiprocessing as mp

import pytest

from rank_prog import rank_main


@pytest.mark.parametrize("model", ["tmgcn", "cdgcn"])
@pytest.mark.parametrize("fault", ["none", "no_exchange"])
def test_four_ranks(model, fault, tmp_path):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=rank_main,
                         args=(r, str(tmp_path / "store"), model, fault, q))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        res = q.get(timeout=240)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    assert all(not p.is_alive() for p in procs)
    assert res["correct"] == (fault == "none"), res
