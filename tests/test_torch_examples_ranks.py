"""The port's rank examples (``examples/torch/partition_compare.py``,
``train_dyngnn_distributed.py``) on gloo ranks under ``torchrun``, held
to the unchanged JAX examples.

Each twin runs twice under ``torchrun --standalone``:

* as the rank program of this module, which hands the twin the JAX
  example's initial parameters (the port draws its own from a seed) and
  writes rank 0's numbers: partition_compare on 4 ranks against the JAX
  example on 4 host devices (both losses 0.703282 at the printed digits,
  ``identical: True``, the comm-volume table digit for digit);
  train_dyngnn_distributed on 2 ranks against the JAX example's own
  ``RunConfig`` run in this process on 2 host devices.  That example is
  cut from 300 to ``TRAIN_STEPS`` eager steps (its 300 take ~70 s on two
  gloo ranks here), which still writes its step-100 checkpoint; losses
  rtol 1e-5, accuracy at its three printed decimals, parameters 1e-4 x
  each leaf's max;
* as the script a user runs, ``--device cpu``: it exits 0, rank 0 alone
  prints, and train_dyngnn_distributed leaves no checkpoint directory
  behind.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
from examples_parity import (ROOT, assert_loss, find, jax_dyngnn_params,
                             jax_example, twin)

PARTITION_P, TRAIN_P = 4, 2
TRAIN_STEPS = 100           # of the example's 300: its first checkpoint
TRAIN_CFG = dict(model="tmgcn", num_nodes=512, num_steps=32, feat_in=2,
                 hidden=6, out_dim=6, window=5, checkpoint_blocks=4)
PARTITION_CFG = dict(model="tmgcn", num_nodes=128, num_steps=16, window=3,
                     checkpoint_blocks=2)
TABLE = r"\s+(\d+)\s+(\S+e\+\d+)\s+(\S+e\+\d+)\s+(\S+e\+\d+)$"
RTOL = 1e-5
TOL_PARAMS = 1e-4


def torchrun(nproc: int, script: Path, *args: str, tmp: Path
             ) -> subprocess.CompletedProcess:
    """``script`` on ``nproc`` gloo ranks; its temporary files under
    ``tmp``."""
    tmp.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), str(script), *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-6000:]
    return proc


def run_ranks(name: str, nproc: int, params_tree, tmp_path: Path,
              *args: str) -> dict:
    """The twin ``name`` on ``nproc`` ranks from ``params_tree`` -> rank
    0's numbers, its printed lines and (when it trains) its parameters."""
    src = tmp_path / "params.pkl"
    src.write_bytes(pickle.dumps(params_tree))
    out = tmp_path / "rank0"
    proc = torchrun(nproc, Path(__file__), name, str(src), str(out), *args,
                    tmp=tmp_path / "tmp")
    got = json.loads(out.with_suffix(".json").read_text())
    got["stdout"] = proc.stdout.splitlines()
    if out.with_suffix(".npz").exists():
        with np.load(out.with_suffix(".npz")) as z:
            got["params"] = dict(z)
    return got


# ----------------------------------------------------- partition_compare ---

def test_partition_compare_on_four_ranks_matches_the_jax_example(tmp_path):
    want = jax_example("partition_compare", PARTITION_P)
    tree, _ = jax_dyngnn_params(**PARTITION_CFG)
    got = run_ranks("partition_compare", PARTITION_P, tree, tmp_path)
    assert got["p"] == PARTITION_P
    assert_loss(got["loss_sp"],
                find(want, r"loss  snapshot-partitioned: (\S+)$").group(1))
    assert_loss(got["loss_ref"],
                find(want, r"loss  single-device ref  : (\S+)$").group(1))
    assert find(want, r"identical: (\w+)$").group(1) == "True"
    assert got["identical"] is True
    rows = [m.groups() for m in map(re.compile(TABLE).match,
                                    want) if m]
    assert len(rows) == 3
    assert [(str(p), f"{s:.3e}", f"{h:.3e}", f"{a:.3e}")
            for p, s, h, a in got["volume"]] == rows
    # the ranks print one copy of the example's lines, rank 0's
    assert got["lines"] == got["stdout"][-len(got["lines"]):]
    same = next(i for i, ln in enumerate(want) if ln.startswith("identical"))
    assert got["lines"][-len(want) + same:] == want[same:]


def test_partition_compare_script_under_torchrun(tmp_path):
    proc = torchrun(PARTITION_P, ROOT / "examples" / "torch" /
                    "partition_compare.py", "--device", "cpu",
                    tmp=tmp_path)
    lines = proc.stdout.splitlines()
    assert find(lines, r"identical: (\w+)$").group(1) == "True"
    find(lines, r"loss  snapshot-partitioned: \d\.\d{6}$")
    assert len([ln for ln in lines if re.match(TABLE, ln)]) == 3


# ---------------------------------------------- train_dyngnn_distributed ---

def jax_train(tmp_path: Path) -> dict:
    """The JAX example's two runs at ``TRAIN_STEPS`` on ``TRAIN_P`` host
    devices, its ``RunConfig``s otherwise as written (parameters from
    ``PRNGKey(0)``)."""
    import jax

    from repro.core import models
    from repro.optim import adamw
    from repro.run import (CheckpointSpec, Engine, ExecutionPlan, RunConfig,
                           SyntheticTrace)

    cfg = models.DynGNNConfig(**TRAIN_CFG)
    data = SyntheticTrace(num_nodes=512, num_steps=32, density=3.0,
                          churn=0.1, smoothing_mode="mproduct", window=5,
                          seed=0)
    engine = Engine(RunConfig(
        model=cfg, data=data,
        plan=ExecutionPlan(mode="eager", shards=TRAIN_P,
                           num_steps=TRAIN_STEPS),
        optimizer=adamw.AdamWConfig(lr=5e-3, warmup_steps=20,
                                    total_steps=TRAIN_STEPS,
                                    weight_decay=0.0),
        checkpoint=CheckpointSpec(str(tmp_path / "jax_ckpt"), every=100),
        log_every=25, log_fn=lambda _m: None))
    mesh = engine.resolve().mesh
    result = engine.fit()
    streamed = Engine(RunConfig(
        model=cfg, data=data,
        plan=ExecutionPlan(mode="streamed_mesh", shards=TRAIN_P,
                           num_epochs=2),
        log_every=4, log_fn=lambda _m: None))
    s_result = streamed.fit()
    named = {jax.tree_util.keystr(k, simple=True, separator="."):
             np.asarray(v) for k, v in
             jax.tree_util.tree_flatten_with_path(result.state.params)[0]}
    return {"mesh": dict(mesh.shape),
            "ratio": engine.resolve().pipeline.transfer_bytes()["ratio"],
            "steps": int(result.state.step), "losses": result.losses,
            "accuracy": engine.evaluate(result),
            "rounds": int(s_result.state.step),
            "stream_losses": s_result.losses, "params": named}


def test_train_dyngnn_distributed_on_two_ranks_matches_jax(tmp_path):
    tree, _ = jax_dyngnn_params(**TRAIN_CFG)
    want = jax_train(tmp_path)
    got = run_ranks("train_dyngnn_distributed", TRAIN_P, tree, tmp_path,
                    str(TRAIN_STEPS))
    assert want["mesh"] == {"data": TRAIN_P, "model": 1}
    assert (got["p"], got["mesh"]) == (TRAIN_P, TRAIN_P)
    assert got["steps"] == want["steps"] == TRAIN_STEPS
    assert got["rounds"] == want["rounds"] == 8
    assert f"{1 / got['ratio']:.2f}" == f"{1 / want['ratio']:.2f}"
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
    np.testing.assert_allclose(got["stream_losses"], want["stream_losses"],
                               rtol=RTOL)
    assert f"{got['accuracy']:.3f}" == f"{want['accuracy']:.3f}"
    assert got["params"].keys() == want["params"].keys()
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=0,
                                   atol=TOL_PARAMS * np.abs(v).max())
    lines = got["lines"]
    assert lines[0] == "mesh: {'data': 2, 'model': 1}"
    find(lines, rf"trained {TRAIN_STEPS} steps; loss \d\.\d{{4}} -> "
                r"\d\.\d{4}$")
    find(lines, r"streamed 8 block rounds on 2 shards; loss ")
    # one checkpoint directory for both ranks, removed by rank 0
    assert list((tmp_path / "tmp").glob("repro_dyngnn_ckpt_*")) == []


def test_train_dyngnn_distributed_script_under_torchrun(tmp_path):
    proc = torchrun(TRAIN_P, ROOT / "examples" / "torch" /
                    "train_dyngnn_distributed.py", "--steps", "4",
                    "--device", "cpu", tmp=tmp_path)
    lines = proc.stdout.splitlines()
    assert find(lines, r"mesh: (.*)$").group(1) == \
        "{'data': 2, 'model': 1}"
    find(lines, r"host->device transfer with graph-diff: \d+\.\d\dx "
                r"reduction$")
    find(lines, r"trained 4 steps; loss ")
    find(lines, r"link-prediction accuracy: \d\.\d{3}$")
    find(lines, r"streamed 8 block rounds on 2 shards; loss ")
    assert list(tmp_path.glob("repro_dyngnn_ckpt_*")) == []


# ------------------------------------------------------ the rank program ---

def _rank_main(name: str, params_path: str, out: str, *args: str) -> None:
    """One rank of ``twin(name).run`` on the CPU from the pickled JAX
    parameter tree; rank 0 writes ``out``.json (its numbers and printed
    lines) and, when it trained, ``out``.npz (its parameters)."""
    from repro_torch import convert

    tree = pickle.loads(Path(params_path).read_bytes())
    lines: list[str] = []

    def echo(msg: str) -> None:
        print(msg, flush=True)
        lines.extend(msg.splitlines())

    kw = {"steps": int(args[0])} if args else {}
    got = twin(name).run(device="cpu", params=convert.params_from_jax(tree),
                         echo=echo, **kw)
    if got is None:
        return
    params = got.pop("params", None)
    got.pop("stream_params", None)
    Path(out + ".json").write_text(json.dumps(dict(got, lines=lines)))
    if params is not None:
        np.savez(out + ".npz", **convert.params_to_numpy(params))


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
