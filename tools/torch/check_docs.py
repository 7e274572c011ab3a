#!/usr/bin/env python
"""Docs checker of the PyTorch port: markdown link integrity + the
runnable examples of ``docs/torch/``.

Two jobs, the port's twin of ``tools/check_docs.py``:

* **link check** — every relative markdown link in README.md and
  docs/torch/*.md must point at a file that exists in the repo (anchors
  into markdown targets are checked against the target's headings with
  GitHub's slug rules).  Links that resolve outside the repo root are
  web-relative (e.g. the CI badge) and skipped, as are absolute URLs.
* **example run** — every ```python fence in the EXAMPLE_DOCS files
  executes, in file order, each file in its own shared interpreter
  namespace (later blocks may use earlier blocks' variables), from the
  repo root (``sampling.md`` reads ``tests/fixtures/`` by a relative
  path).  The namespace starts with ``device`` bound to ``--device``:
  ``cuda`` (the card, as the fences run when pasted) unless the caller
  asks for ``cpu``.  The tracer is reset between files.  A fence whose
  info string says ``ranks=N`` (```` ```python ranks=4 ````) needs a
  process group of N ranks: under ``torchrun --nproc-per-node N`` every
  rank runs it; a smaller run names it and passes it by.

``--values OUT.json`` writes the numbers each fence computed
(``FENCE_VALUES``: an expression evaluated in the file's namespace after
the fence, and its kind), so that two runs — the card's and the CPU's —
can be held to each other (``compare_values``).

Usage::

    python tools/torch/check_docs.py [--no-run | --no-links] [--device cpu]
        [--values OUT.json] [DOC.md ...]
    torchrun --standalone --nproc-per-node 4 tools/torch/check_docs.py \
        --device cpu run_api.md compression.md
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
DOCS = REPO / "docs" / "torch"
EXAMPLE_DOCS = ("run_api.md", "serve_api.md", "sampling.md",
                "compression.md", "observability.md")
LINK_RE = re.compile(r"\[[^\]]*\]\(([^)\s]+)\)")
HEADING_RE = re.compile(r"^#{1,6}\s+(.*)$", re.MULTILINE)
FENCE_RE = re.compile(r"^```python([^\n]*)\n(.*?)^```",
                      re.MULTILINE | re.DOTALL)
RANKS_RE = re.compile(r"\branks=(\d+)\b")

#: per doc, per fence: {expression evaluated after the fence: its kind}.
#: ``exact`` values (counts, bytes, shapes, knobs, strings) must be
#: equal; ``loss`` values are held relative, ``score`` values to a
#: fraction of their largest magnitude, ``int8`` values (losses of a
#: quantized run) absolutely.  A fence that defines none of its names (a
#: guarded fence that did not run) records no values.
FENCE_VALUES: dict[str, list[dict[str, str]]] = {
    "run_api.md": [
        {"result.losses": "loss", "acc": "exact",
         "result.state.step": "exact",
         "result.transfer_report": "exact"},
        {"stream_res.losses": "loss",
         "vars(stream_res.stream_report)": "exact"},
        {"mesh_res.losses": "loss", "mesh_res.per_shard_bytes": "exact",
         "(mesh_res.a2a_chunks, mesh_res.pipeline_rounds)": "exact"},
        {"elastic_res.losses": "loss",
         "[(e.block, e.old_p, e.new_p, e.payload_bytes, e.cause) "
         "for e in elastic_res.rescale_report.events]": "exact",
         "elastic_res.rescale_report.widths": "exact"},
        {"(tmp / 'trace.tsv').read_text()": "exact",
         "file_res.losses": "loss"},
        {"first.losses": "loss", "more.losses": "loss",
         "(first.state.step, more.state.step)": "exact"},
    ],
    "serve_api.md": [
        {"fit.losses": "loss", "node_scores": "score",
         "link_scores": "score", "(pipe.bsize, pipe.max_edges)": "exact",
         "(len(stream.src), n, w)": "exact"},
        {"a.scores": "score", "b.scores": "score",
         "(a.done, b.done)": "exact"},
        {"(r.family, r.events_ingested, r.windows_advanced, r.resyncs, "
         "r.queries, r.query_batches)": "exact"},
    ],
    "sampling.md": [
        {"result.losses": "loss",
         "(rep.rounds, rep.sampled_edges, rep.sampled_nodes, "
         "rep.dropped_nodes, rep.dropped_edges, rep.staged_bytes, "
         "rep.table_fill_max)": "exact"},
        {"(store.num_steps, store.nbytes)": "exact",
         "(g3.indptr, g3.indices)": "exact",
         "store.values_csr(3)": "exact", "store.edges(3)": "exact"},
        {"(r.num_seeds, r.table_pad, r.edge_pad)": "exact"},
        {"budget": "exact", "res.losses": "loss",
         "res.budget_report": "exact"},
        {"(ds.num_nodes, ds.num_steps)": "exact",
         "[s.tolist() for s in ds.snapshots]": "exact"},
    ],
    "compression.md": [
        {"results['none'].losses": "loss",
         "results['int8_all'].losses": "int8",
         "[results[m].per_shard_bytes for m in ('none', 'int8_all')]":
             "exact",
         "[results[m].compression for m in ('none', 'int8_all')]":
             "exact"},
        {"(f32, q, f32_delta, q_delta)": "exact"},
    ],
    "observability.md": [
        {"[s.name for s in spans]": "exact",
         "tracer.summary()['round']['count']": "exact"},
        {"(off.spans(), off.span('anything') is NULL_SPAN)": "exact"},
        {"meta['format']": "exact",
         "sorted({e['name'] for e in events if e['ph'] == 'X'})": "exact"},
        {"result.losses": "loss",
         "(m['counters']['sample.rounds'], "
         "m['counters']['sample.staged_bytes'], m['spans'])": "exact"},
        {"[(row.round, row.measured_s, row.measured_round_s, "
         "row.predicted_s, row.residual_s, row.phase_residual_s) "
         "for row in rep.rows]": "exact",
         "rep.baseline_s": "exact", "rep.summary()": "exact"},
    ],
}


def doc_files() -> list[Path]:
    return [REPO / "README.md"] + sorted(DOCS.glob("*.md"))


def github_slug(heading: str) -> str:
    """GitHub's heading -> anchor slug (enough of it for our docs)."""
    s = re.sub(r"`([^`]*)`", r"\1", heading.strip()).lower()
    s = re.sub(r"[^\w\- ]", "", s)
    return s.replace(" ", "-")


def check_links(files: list[Path] | None = None) -> list[str]:
    """-> list of 'file: broken link' problems (empty = all good)."""
    problems: list[str] = []
    for md in files or doc_files():
        text = md.read_text()
        for target in LINK_RE.findall(text):
            if re.match(r"^[a-z][a-z0-9+.-]*:", target):   # http:, mailto:
                continue
            path_part, _, fragment = target.partition("#")
            if not path_part:                  # same-file anchor
                dest = md
            else:
                dest = (md.parent / path_part).resolve()
                if REPO not in dest.parents and dest != REPO:
                    continue                   # web-relative (CI badge)
                if not dest.exists():
                    problems.append(f"{md.relative_to(REPO)}: broken link "
                                    f"-> {target}")
                    continue
            if fragment and dest.suffix == ".md":
                slugs = {github_slug(h)
                         for h in HEADING_RE.findall(dest.read_text())}
                if fragment not in slugs:
                    problems.append(f"{md.relative_to(REPO)}: missing "
                                    f"anchor -> {target}")
    return problems


def fences(md: Path) -> list[tuple[int, str]]:
    """``md``'s ```python fences -> [(ranks it needs, its code)]."""
    out = []
    for info, code in FENCE_RE.findall(md.read_text()):
        m = RANKS_RE.search(info)
        out.append((int(m.group(1)) if m else 1, code))
    return out


def python_blocks(md: Path) -> list[str]:
    return [code for _, code in fences(md)]


def world_size() -> int:
    """Ranks of the open process group (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def plain(x):
    """``x`` as JSON-ready Python: tensors and arrays (of either
    framework) as nested lists, tuples as lists."""
    if hasattr(x, "detach"):                              # torch.Tensor
        x = x.detach().cpu().numpy()
    if isinstance(x, (str, bool, int, float)) or x is None:
        return x
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, dict):
        return {str(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return np.asarray(x).tolist()                         # jax.Array too


def fence_values(doc: str, i: int, ns: dict) -> dict:
    """``FENCE_VALUES[doc][i]`` evaluated in ``ns`` -> {expression:
    value}; {} when the fence defined none of its names."""
    out = {}
    for expr in FENCE_VALUES[doc][i]:
        try:
            out[expr] = plain(eval(expr, ns))  # noqa: S307
        except NameError:
            continue
    return out


def run_examples(md: Path, device: str = "cuda", verbose: bool = True,
                 echo=print) -> list[dict]:
    """Execute one doc's ```python blocks in one shared namespace, with
    ``device`` bound -> each fence's values (``fence_values``; None for a
    fence this run's group is too small for); raises on the first failing
    block."""
    from repro_torch import obs

    blocks = fences(md)
    if not blocks:
        raise AssertionError(f"{md}: no python examples found")
    obs.configure(enabled=False)       # the tracer is global: start clean
    ns: dict = {"__name__": "__docs__", "device": device}
    values: list = []
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        for i, (ranks, block) in enumerate(blocks):
            head = block.strip().splitlines()[0]
            tag = f"[check_docs] {md.name} block {i + 1}/{len(blocks)}"
            if ranks > world_size():
                echo(f"{tag}: needs {ranks} ranks, this run has "
                     f"{world_size()}: not run (torchrun --standalone "
                     f"--nproc-per-node {ranks} tools/torch/check_docs.py "
                     f"... {md.name})")
                values.append(None)
                continue
            if verbose:
                echo(f"{tag}: {head}")
            code = compile(block, f"{md.name}#block{i + 1}", "exec")
            exec(code, ns)  # noqa: S102
            values.append(fence_values(md.name, i, ns))
    finally:
        os.chdir(cwd)
        obs.configure(enabled=False)
    return values


def run_all_examples(device: str = "cuda", names=EXAMPLE_DOCS,
                     verbose: bool = True, echo=print) -> dict:
    """Execute every doc of ``names``, each in a fresh namespace ->
    {doc: its fences' values}."""
    return {name: run_examples(DOCS / name, device, verbose, echo)
            for name in names}


def _close(got, want, tol: float, scale: float | None) -> bool:
    a = np.asarray(got, dtype=np.float64)
    b = np.asarray(want, dtype=np.float64)
    if a.shape != b.shape:
        return False
    lim = tol * (scale if scale is not None else np.abs(b))
    return bool(np.all(np.abs(a - b) <= lim))


def compare_values(got: dict, want: dict, tols: dict[str, float]
                   ) -> list[str]:
    """One run's ``run_all_examples`` values against another's ->
    problems (empty = they agree).  ``exact`` values must be equal;
    ``loss`` within ``tols['loss']`` relative, ``score`` within
    ``tols['score']`` x the largest |want|, ``int8`` within
    ``tols['int8']`` absolute."""
    problems = []
    for doc, fences_want in want.items():
        for i, (g, w) in enumerate(zip(got[doc], fences_want, strict=True)):
            if (g is None) != (w is None) or (g is not None and
                                              g.keys() != w.keys()):
                problems.append(f"{doc} block {i + 1}: ran with values "
                                f"{g and sorted(g)} against {w and sorted(w)}")
                continue
            for expr, want_v in (w or {}).items():
                kind = FENCE_VALUES[doc][i][expr]
                got_v = g[expr]
                if kind == "exact":
                    ok = got_v == want_v
                elif kind == "loss":
                    ok = _close(got_v, want_v, tols["loss"], None)
                elif kind == "score":
                    ok = _close(got_v, want_v, tols["score"],
                                float(np.abs(np.asarray(want_v)).max()))
                else:
                    ok = _close(got_v, want_v, tols["int8"], 1.0)
                if not ok:
                    problems.append(f"{doc} block {i + 1}: {expr} ({kind}) "
                                    f"{got_v!r:.300} against "
                                    f"{want_v!r:.300}")
    return problems


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="tools/torch/check_docs.py")
    ap.add_argument("docs", nargs="*", metavar="DOC.md",
                    help=f"docs to run (default: {' '.join(EXAMPLE_DOCS)})")
    skip = ap.add_mutually_exclusive_group()
    skip.add_argument("--no-run", action="store_true",
                    help="link check only, skip executing the examples")
    skip.add_argument("--no-links", action="store_true",
                    help="examples only, skip the link check (which reads "
                         "files, not the device: a checkout that leaves "
                         "out a linked file fails it wherever it runs)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the fences run (default: the card)")
    ap.add_argument("--values", metavar="OUT.json",
                    help="write each fence's values (rank 0)")
    args = ap.parse_args(argv)
    unknown = set(args.docs) - set(EXAMPLE_DOCS)
    if unknown:
        ap.error(f"not an example doc: {sorted(unknown)}")
    sys.path.insert(0, str(REPO / "src"))
    import torch.distributed as dist

    from repro_torch.elastic.reshard import drop_width_groups
    from repro_torch.launch.mesh import join_world

    # under torchrun every rank runs every fence; rank 0 prints
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        join_world(args.device)
    rank = dist.get_rank() if dist.is_initialized() else 0

    def echo(msg: str) -> None:
        if rank == 0:
            print(msg, flush=True)

    if not args.no_links:
        problems = check_links()
        for p in problems:
            echo(f"[check_docs] FAIL {p}")
        if problems:
            return 1
        echo(f"[check_docs] links OK across "
             f"{', '.join(f.name for f in doc_files())}")
    try:
        if not args.no_run:
            values = run_all_examples(args.device,
                                      tuple(args.docs) or EXAMPLE_DOCS,
                                      echo=echo)
            if args.values and rank == 0:
                Path(args.values).write_text(json.dumps(values))
            echo(f"[check_docs] examples OK on {args.device} "
                 f"({world_size()} rank{'s' if world_size() > 1 else ''})")
    finally:
        if dist.is_initialized():
            drop_width_groups()
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
