"""The port's run_api.md and compression.md twins on 4 gloo ranks, held
to the JAX docs on 8 host devices.

* One module pool of 4 spawned gloo ranks (a ``FileStore`` in
  ``tmp_path``, a join deadline that kills the ranks) runs every fence of
  ``docs/torch/run_api.md`` and ``compression.md`` through
  ``tools/torch/check_docs.py``, each Engine from the JAX init of its
  run: the pipelined ``streamed_mesh`` at 4 shards, the elastic 2 -> 4
  rescale and the int8 comparison run, and the one-rank fences (eager,
  streamed, file round trip, checkpoint + resume) on every rank.  Every
  rank's values equal rank 0's, and rank 0's are held to the JAX
  fences' (``docs_parity.TOL``: losses rtol 1e-5, the int8 run atol
  1e-4 — ROADMAP's TM-GCN bound —, bytes, knobs, the ``RescaleEvent``
  fields and the written trace file exactly).
* One process runs both docs as a user's lone process does: the two
  guarded fences and compression's 4-rank fence do not run, the rest
  match the JAX fences.

The checker itself under ``torchrun`` is ``test_torch_docs.py``'s.
"""

from __future__ import annotations

import datetime
import pickle
import time
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from docs_parity import assert_values, jax_docs, jax_inits, port_tool

P = 4
JAX_DOCS = ("run_api.md", "compression.md")
POOL_DEADLINE_S = 180
GUARDED = {"run_api.md": (2, 3), "compression.md": ()}


def _run(inits: dict) -> dict:
    """run_api.md and compression.md on the CPU from the JAX inits ->
    their fences' values."""
    with jax_inits(inits):
        return port_tool().run_all_examples("cpu", JAX_DOCS, verbose=False,
                                            echo=lambda _m: None)


def _rank_main(rank: int, store: str, inits_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, P),
                            rank=rank, world_size=P,
                            timeout=datetime.timedelta(seconds=90))
    try:
        values = _run(pickle.loads(Path(inits_path).read_bytes()))
        (Path(out_dir) / f"rank{rank}.pkl").write_bytes(pickle.dumps(values))
    finally:
        from repro_torch.elastic.reshard import drop_width_groups
        drop_width_groups()
        dist.destroy_process_group()


def run_ranks(fn, nprocs: int, args: tuple, deadline_s: float) -> None:
    """Start ``nprocs`` spawned ranks of ``fn(rank, *args)`` and join them
    by ``deadline_s``; a rank's failure, or the deadline, kills the rest
    and fails."""
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=max(end - time.monotonic(), 0.0)):
            if time.monotonic() >= end:
                raise TimeoutError(f"{nprocs} ranks still running after "
                                   f"{deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


@pytest.fixture(scope="module")
def jax_values(tmp_path_factory):
    return jax_docs(JAX_DOCS, tmp_path_factory.mktemp("jax_docs"))


@pytest.fixture(scope="module")
def pool(jax_values, tmp_path_factory):
    """Every rank's values -> [rank 0's, ..., rank 3's]."""
    d = tmp_path_factory.mktemp("docs_ranks")
    inits = d / "inits.pkl"
    inits.write_bytes(pickle.dumps(jax_values["inits"]))
    run_ranks(_rank_main, P, (str(d / "store"), str(inits), str(d)),
              POOL_DEADLINE_S)
    return [pickle.loads((d / f"rank{r}.pkl").read_bytes())
            for r in range(P)]


@pytest.fixture(scope="module")
def alone(jax_values):
    """The two docs in this process, as a lone user process runs them."""
    return _run(jax_values["inits"])


@pytest.mark.parametrize("doc", JAX_DOCS)
def test_every_fence_on_four_ranks_matches_the_jax_doc(doc, pool,
                                                       jax_values):
    got = pool[0][doc]
    assert all(got), (doc, got)                 # every fence ran
    assert_values(pool[0], jax_values["values"], [doc])


def test_the_distributed_fences_report_four_ranks(pool):
    run_api = pool[0]["run_api.md"]
    assert len(run_api[2]["mesh_res.per_shard_bytes"]) == 4
    assert run_api[2]["(mesh_res.a2a_chunks, mesh_res.pipeline_rounds)"] \
        == [4, True]
    assert run_api[3]["elastic_res.rescale_report.widths"] == [2, 4]
    events = run_api[3]["[(e.block, e.old_p, e.new_p, e.payload_bytes, "
                        "e.cause) for e in elastic_res.rescale_report."
                        "events]"]
    assert [e[:3] for e in events] == [[1, 2, 4]] and events[0][3] > 0
    bytes_ = pool[0]["compression.md"][0][
        "[results[m].per_shard_bytes for m in ('none', 'int8_all')]"]
    assert sum(bytes_[1]) < sum(bytes_[0])


def test_every_rank_computes_rank_0_s_values(pool):
    for r in range(1, P):
        assert port_tool().compare_values(
            pool[r], pool[0], {"loss": 0.0, "score": 0.0, "int8": 0.0}) \
            == [], r


@pytest.mark.parametrize("doc", JAX_DOCS)
def test_a_lone_process_skips_the_four_rank_fences(doc, alone, jax_values):
    got = alone[doc]
    for i, v in enumerate(got):
        if i in GUARDED[doc]:
            assert v == {}, (doc, i)            # the guard was false
        elif doc == "compression.md" and i == 0:
            assert v is None                    # ranks=4: not run
        else:
            assert v, (doc, i)
    want = {doc: [w if v else v
                  for v, w in zip(got, jax_values["values"][doc])]}
    assert_values(alone, want, [doc])
