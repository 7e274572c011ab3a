"""The port's example docs (``docs/torch/``) and their checker
(``tools/torch/check_docs.py``), held to the JAX package's docs.

* The link check over README.md and ``docs/torch/*.md`` passes.
* Each twin has as many ```python fences as its JAX doc, in the same
  order: fence i of the twin makes fence i's assertions, statement for
  statement.
* serve_api.md, sampling.md and observability.md execute on
  ``device="cpu"`` in one process, each Engine started from the JAX
  init of its run (``docs_parity.jax_inits``), and every fence's values
  (``FENCE_VALUES``) are held to the same fences of the JAX docs run in
  a subprocess on 8 host devices: losses rtol 1e-5, scores 1e-4 x their
  largest magnitude, counts, bytes, shapes, CSR arrays, span names and
  the calibration rows exactly.  run_api.md and compression.md are
  ``test_torch_docs_ranks.py``'s.
* The checker's command line: the default device is the card and raises
  here (no fence falls back to the CPU); ``--device cpu`` passes the
  4-rank fence of compression.md by, by name, and writes the values;
  under ``torchrun`` on 4 gloo ranks it runs that fence, and the
  one-shard sampled plans of sampling.md draw the lone process's
  subgraphs.
"""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from docs_parity import ROOT, assert_values, jax_docs, jax_inits, jax_tool, \
    port_tool

DOCS = ("serve_api.md", "sampling.md", "observability.md")
tool = port_tool()


@pytest.fixture(scope="module")
def jax_values(tmp_path_factory):
    return jax_docs(DOCS, tmp_path_factory.mktemp("jax_docs"))


@pytest.fixture(scope="module")
def port_values(jax_values):
    """The three docs on the CPU in this process from the JAX inits; the
    one-rank group sampling.md joins is closed after them."""
    try:
        with jax_inits(jax_values["inits"]):
            return tool.run_all_examples("cpu", DOCS, verbose=False,
                                         echo=lambda _m: None)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _asserts(code: str) -> list[str]:
    return [ast.unparse(n) for n in ast.walk(ast.parse(code))
            if isinstance(n, ast.Assert)]


def test_links_resolve():
    assert tool.check_links() == []
    names = {f.relative_to(ROOT).as_posix() for f in tool.doc_files()}
    assert {f"docs/torch/{d}" for d in tool.EXAMPLE_DOCS} | {"README.md"} \
        <= names


@pytest.mark.parametrize("doc", tool.EXAMPLE_DOCS)
def test_twin_has_the_jax_doc_s_fences_in_order(doc):
    mine = tool.python_blocks(ROOT / "docs" / "torch" / doc)
    ref = jax_tool().python_blocks(ROOT / "docs" / doc)
    assert len(mine) == len(ref) == len(tool.FENCE_VALUES[doc])
    for i, (a, b) in enumerate(zip(mine, ref)):
        assert _asserts(a) == _asserts(b), (doc, i)
    # the first fence says where it runs
    assert 'device = globals().get("device", "cuda")' in mine[0]


@pytest.mark.parametrize("doc", DOCS)
def test_twin_fences_match_the_jax_doc_on_the_cpu(doc, port_values,
                                                  jax_values):
    got, want = port_values[doc], jax_values["values"][doc]
    assert all(v for v in got), (doc, got)        # every fence ran
    assert_values(port_values, jax_values["values"], [doc])


def test_the_comparison_catches_a_moved_value(port_values, jax_values):
    """``assert_values`` is not vacuous: a loss moved past 1e-5, one count
    off, or a fence that ran on one side only, each fail it."""
    want = jax_values["values"]
    for doc, i, expr, bump in (
            ("sampling.md", 0, "result.losses",
             lambda v: [v[0] * (1 + 3e-5)] + v[1:]),
            ("sampling.md", 2, "(r.num_seeds, r.table_pad, r.edge_pad)",
             lambda v: [v[0] + 1] + v[1:]),
            ("serve_api.md", 0, "node_scores",
             lambda v: [[x + 2e-4 * abs(x) + 1e-3 for x in row]
                        for row in v])):
        moved = {d: [dict(f) for f in fs] for d, fs in port_values.items()}
        moved[doc][i][expr] = bump(moved[doc][i][expr])
        with pytest.raises(AssertionError, match=re.escape(expr)):
            assert_values(moved, want, [doc])
    skipped = {d: list(fs) for d, fs in port_values.items()}
    skipped["observability.md"][1] = None
    with pytest.raises(AssertionError, match="block 2: ran"):
        assert_values(skipped, want, ["observability.md"])


def _checker(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, str(ROOT / "tools" / "torch" / "check_docs.py"),
         *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)


def test_checker_cli_on_the_cpu_names_the_fence_it_passes_by(tmp_path):
    out = tmp_path / "values.json"
    proc = _checker("--device", "cpu", "--values", str(out),
                    "compression.md", "observability.md")
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert "[check_docs] links OK across README.md, " in proc.stdout
    assert ("[check_docs] compression.md block 1/2: needs 4 ranks, this run "
            "has 1: not run (torchrun --standalone --nproc-per-node 4 "
            "tools/torch/check_docs.py ... compression.md)") in lines
    assert lines[-1] == "[check_docs] examples OK on cpu (1 rank)"
    values = json.loads(out.read_text())
    assert values["compression.md"][0] is None
    assert set(values["compression.md"][1]) == {"(f32, q, f32_delta, q_delta)"}
    assert len(values["observability.md"]) == 5


def test_checker_under_torchrun(tmp_path, port_values):
    """``torchrun --nproc-per-node 4 tools/torch/check_docs.py --device
    cpu compression.md sampling.md``: rank 0 alone prints, the 4-rank
    fence runs, and the one-shard sampled plans (each rank on its own
    one-rank group of the four) draw what the lone process drew: every
    value that does not depend on the initial parameters equal."""
    out = tmp_path / "values.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", str(ROOT / "tools" / "torch" /
                                       "check_docs.py"),
         "--device", "cpu", "--values", str(out), "compression.md",
         "sampling.md"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-6000:]
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("[check_docs]")]
    assert len(lines) == 1 + 2 + 5 + 1          # links, fences, OK
    assert lines[-1] == "[check_docs] examples OK on cpu (4 ranks)"
    values = json.loads(out.read_text())
    assert all(values["compression.md"]) and all(values["sampling.md"])
    exact = [{k: v for k, v in f.items()
              if tool.FENCE_VALUES["sampling.md"][i][k] == "exact"}
             for i, f in enumerate(values["sampling.md"])]
    assert exact == [{k: v for k, v in f.items() if k in e}
                     for f, e in zip(port_values["sampling.md"], exact)]


def test_checker_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")
    proc = _checker("serve_api.md")
    if proc.returncode == 0:
        pytest.fail("ran without a card: " + proc.stdout[-2000:])
    assert "no CUDA device" in proc.stderr
    assert "serve_api.md block 1/3" in proc.stdout


def test_checker_link_check_finds_broken_links(tmp_path, monkeypatch):
    monkeypatch.setattr(tool, "REPO", tmp_path)
    (tmp_path / "there.md").write_text("# A heading\n")
    md = tmp_path / "doc.md"
    md.write_text("[ok](there.md#a-heading) [web](https://x.org/y) "
                  "[gone](nowhere.md) [anchor](there.md#no-such-heading) "
                  "[here](#title)\n# Title\n")
    assert tool.check_links([md]) == [
        "doc.md: broken link -> nowhere.md",
        "doc.md: missing anchor -> there.md#no-such-heading"]


def test_checker_no_links_runs_the_fences_past_a_broken_link(
        tmp_path, monkeypatch, capsys):
    """A checkout that leaves out a linked file fails the link check;
    ``--no-links`` (the card's run of the fences) passes it by and still
    runs them, ``--no-run`` and ``--no-links`` exclude each other."""
    md = tmp_path / "doc.md"
    md.write_text("[gone](nowhere.md)\n")
    monkeypatch.setattr(tool, "REPO", tmp_path)
    monkeypatch.setattr(tool, "doc_files", lambda: [md])
    assert tool.main(["--device", "cpu", "compression.md"]) == 1
    assert capsys.readouterr().out == \
        "[check_docs] FAIL doc.md: broken link -> nowhere.md\n"
    assert tool.main(["--no-links", "--device", "cpu", "compression.md"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert not any("link" in line for line in lines)
    assert lines[-1] == "[check_docs] examples OK on cpu (1 rank)"
    with pytest.raises(SystemExit):
        tool.main(["--no-run", "--no-links"])
