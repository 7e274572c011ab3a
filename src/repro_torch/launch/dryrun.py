"""Dry run of every (arch x shape) cell against one card: which cells fit,
and what one step of each costs.

    python -m repro_torch.launch.dryrun --arch yi-6b --shape long_500k [--run]
    python -m repro_torch.launch.dryrun --all [--run] [--out DIR]
    python -m repro_torch.launch.dryrun --all --capacity 85000000000 \\
        --device cpu
    python -m repro_torch.launch.dryrun --all --grid 2x4 --device cpu \\
        --capacity 85017493504

The torch meaning of ``repro.launch.dryrun``.  For each cell
(``launch.steps.build_cell`` on a 1 x 1 grid) :func:`reckon` adds up

* the **argument bytes** -- parameters, optimizer state, inputs and caches
  -- exactly, from the cell's ``abstract_inputs``;
* the **work bytes** the step holds beside them at its peak, per family
  (:func:`work_bytes`): an LM's checkpointed layer inputs, one layer's
  recompute and its gradients, the output cache of a prefill; the static
  GNNs' checkpointed layer inputs and one layer's edge tensors and their
  gradients; DIN's (rows, L, 144) features and the tensors after them; the
  dyngnn cell's CSR pairs, block carries and one block's recompute;
  gradients and AdamW's new state for every train step;
* :data:`WORKSPACE` bytes for cuBLAS's workspaces and the allocator's
  rounding, and :data:`RESERVE` bytes for what the allocator does not
  count (the CUDA context, a one-rank NCCL group);

and holds the sum against the card's capacity:
``torch.cuda.get_device_properties(0).total_memory``, or ``--capacity``
when no card is asked for (``--device cpu``, as the tests do).  ``--run``
takes one step of every cell that fits on the card (a one-rank NCCL group
for the dyngnn cells; the allocator's segments expandable, see
:func:`expandable_segments`) and prints its ms (host clock, synchronized)
and ``max_memory_allocated`` beside the reckoning.  Results go to ``--out``
(default ``results/dryrun_torch``, which git ignores), one JSON file a
cell.

``--grid DxM`` reckons every cell per rank of a ``D x M`` grid of cards
(:func:`reckon` with ``grid``): a rank's argument bytes exactly from the
cell's specs (``in_specs``: each dimension cut by the ranks its axes
name), its work bytes from the same terms cut as the layouts cut them --
an LM's rows of the batch over data, heads, ``d_ff`` and the vocabulary
over model (an MoE layer's expert batch is cut by the model axis alone,
since its slots are the global batch's); a static GNN's edge lanes and
checkpointed node rows over data, beside the whole-graph tensors a layer
gathers (a replica cell: one replica a data rank); DIN's rows or
candidates over data and its tables over model; a dyngnn cell's steps of
each block and its vertex-sharded carries over data.  For every cell one
card cannot hold it then prints the smallest power-of-two grid of such
cards, model at most 8, at which every rank fits (:func:`smallest_grid`;
a GNN's model axis holds copies, so its grid is D x 1), and "fits one
card" for the others.

The dyngnn cells also get :func:`dyngnn_analytic`, the reference's
hardware-free flops, bytes and collective bytes (copied), and a roofline
over the card's rates (:data:`CARD`).

Left out, with no counterpart: the XLA lowering and ``compile()`` and
their memory and cost analyses, the HLO collective parse
(``collective_bytes``), the two-point unrolled LM cost correction, and
the TPU v5e constants -- the port runs eagerly, so its cost is what the
card measures.
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import torch

from repro_torch import obs
from repro_torch.launch import steps as steps_mod

#: the card the roofline's rates are for, and the rates (dense, per card)
CARD = "NVIDIA H100 80GB HBM3 (SXM5)"
PEAK_FP32 = 67e12          # FLOP/s, fp32 on the CUDA cores (dyngnn is f32)
PEAK_BF16 = 989e12         # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12           # bytes/s
NVLINK_BW = 450e9          # bytes/s, each way

#: bytes outside the allocator's count: the CUDA context (~0.65 GB on the
#: H100) and a one-rank NCCL group (~0.6 GB)
RESERVE = 1_500_000_000
#: bytes inside it that no term names: cuBLAS's workspaces and the
#: allocator's rounding (a ``long_500k`` decode step's peak read 0.20 GB
#: over its arguments on the H100: ``chip_smoke.py``'s cells group)
WORKSPACE = 512 << 20

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

#: floats a dyngnn block holds per (step, vertex) at its backward's peak
#: at the registry's widths (2 -> 6 -> 6, two layers): its recompute's
#: saved tensors and the gradients beside them.  On the H100
#: the peak less the arguments, CSR pairs and carries reads TM-GCN
#: 38.7-39.4, CD-GCN 146.4 and EvolveGCN 72.5-72.8 at full T
#: (``chip_smoke.py``'s cells group prints it a cell); these hold 9-24 %
#: more, so a cell the reckoning passes does not run out of memory
DYNGNN_BLOCK_FLOATS = {"tmgcn": 48, "cdgcn": 160, "evolvegcn": 80}


def _f32(*dims) -> int:
    return 4 * math.prod(dims)


def _train_state_bytes(n_params: int, param_bytes: int) -> int:
    """Gradients (in the parameters' dtype) and AdamW's new m, v and
    master (fp32) while the old state is alive."""
    return param_bytes + 12 * n_params


def _params(cell) -> tuple[int, int]:
    """(count, bytes) of the cell's parameters (its first input)."""
    leaves = steps_mod.input_leaves(cell.abstract_inputs[0]).values()
    return (sum(t.numel() for t in leaves),
            sum(t.numel() * t.element_size() for t in leaves))


def _lm_work(cell, grid=None) -> dict:
    """An LM step's work bytes; with ``grid`` (``D x M`` ranks) a rank's:
    rows over data when the batch is split, query heads, ``d_ff`` (or
    experts) and the vocabulary over model where the layout splits them,
    the attention chunk's rows where it splits those."""
    cfg, d = cell.config, cell.shape.dims
    b, s = d["global_batch"], d["seq_len"]
    w = torch.empty((), dtype=cfg.dtype).element_size()
    lay = cell.layout if grid is not None else None
    pd, pm = (grid.pd, grid.pm) if lay is not None else (1, 1)
    rows = b // pd if lay is None or lay.batch else b
    heads = cfg.num_heads // (pm if lay is not None and lay.heads else 1)
    kvh = cfg.num_kv_heads // (pm if lay is not None and lay.kv_heads
                               else 1)
    cut = pm if lay is not None and (lay.ffn or lay.experts) else 1
    vp = cfg.padded_vocab // (pm if lay is not None and lay.vocab else 1)
    dm, qkv = cfg.d_model, (heads + 2 * kvh) * cfg.head_dim
    # an MoE's expert batch holds the global batch's slots on every rank
    ffn_rows = b if cfg.is_moe and lay is not None else rows
    ffn = cfg.d_ff * (cfg.moe_top_k * cfg.moe_capacity_factor
                      if cfg.is_moe else 1) / cut
    if cell.kind == "decode":
        kv_rows = s
        if lay is not None and lay.kv_seq:
            kv_rows = s // (pm if lay.kv_seq == "model" else pd * pm)
        splits = -(-kv_rows // 4096)
        return {"layer": int((rows * (4 * dm + qkv)
                              + ffn_rows * 3 * ffn) * w),
                "attention partials": _f32(rows, cfg.num_heads, splits,
                                           cfg.head_dim + 2),
                "logits": _f32(rows, vp)}
    layer = int((rows * s * (4 * dm + qkv) + ffn_rows * s * 3 * ffn) * w)
    q_rows = min(cfg.q_chunk, s)
    if lay is not None and lay.seq_chunks and s > q_rows:
        q_rows //= pm
    scores = _f32(rows, heads, q_rows, s)
    if cell.kind == "prefill":
        if lay is None:
            cache = 2 * cfg.num_layers * b * s * cfg.num_kv_heads \
                * cfg.head_dim * w
        else:
            cache = _spec_bytes(_prefill_cache(cell), cell.out_specs[1],
                                grid)
        return {"output cache": cache,
                "layer": layer, "scores": scores, "logits": _f32(rows, vp)}
    if lay is None:
        n, pb = _params(cell)
        state = _train_state_bytes(n, pb)
    else:
        leaves = _local_leaves(cell, grid)
        params = {k: v for k, v in leaves.items() if k.startswith("0.")}
        pb = sum(params.values())
        n_p = sum(v // (4 if "router" in k else w)
                  for k, v in params.items())
        n_opt = sum(v for k, v in leaves.items()
                    if k.startswith("1.m.")) // 4
        # gradients, their fp32 sums over data, the new m, v and master
        state = pb + (4 * n_p if pd > 1 else 0) + 12 * n_opt
    return {"gradients and AdamW": state,
            "checkpointed layer inputs": cfg.num_layers * rows * s * dm * w,
            "layer recompute and gradients": 2 * layer + 2 * scores,
            "head chunk": 2 * _f32(rows, min(cfg.loss_chunk or s, s), vp)}


def _prefill_cache(cell) -> dict:
    """A prefill cell's output cache, as meta tensors."""
    from repro_torch.models import lm
    return steps_mod._tree_map(steps_mod._meta, lm.init_kv_cache(
        cell.config, cell.shape.dims["global_batch"],
        cell.shape.dims["seq_len"], device="meta"))


def flat_in_specs(specs) -> dict:
    """A cell's ``in_specs`` (or any tuple of spec trees) -> {input path
    (``steps.input_leaves``'): spec}."""
    from repro_torch.dist.sharding import flat_specs
    out = {}
    for i, sp in enumerate(specs):
        if isinstance(sp, dict):
            out.update({f"{i}.{k}": v for k, v in flat_specs(sp).items()})
        else:
            out[str(i)] = sp
    return out


def _local_bytes(t, sp: tuple, grid) -> int:
    from repro_torch.dist.sharding import shard_slices
    n = 1
    for sl, size in zip(shard_slices(tuple(t.shape), sp, grid), t.shape):
        n *= (sl.stop - sl.start) if sl.stop is not None else size
    return n * t.element_size()


def _local_leaves(cell, grid) -> dict:
    """{input path: bytes a rank of ``grid`` holds} of the cell's
    inputs, from its ``in_specs``."""
    specs = flat_in_specs(cell.in_specs)
    return {k: _local_bytes(t, specs[k], grid)
            for k, t in steps_mod.input_leaves(cell.abstract_inputs)
            .items()}


def _spec_bytes(tree: dict, specs: dict, grid) -> int:
    from repro_torch.dist.sharding import flat_specs
    flat = flat_specs(specs)
    return sum(_local_bytes(t, flat[k], grid)
               for k, t in steps_mod.input_leaves(tree).items())


def _data_ranks(grid) -> int:
    return 1 if grid is None else grid.pd


def _grad_sums(cell, grid) -> int:
    """The fp32 copies of the gradients a data column sums (none on one
    data rank)."""
    if _data_ranks(grid) == 1:
        return 0
    return 4 * sum(v // 4 for k, v in _local_leaves(cell, grid).items()
                   if k.startswith("0."))


def _gnn_work(cell, grid=None) -> dict:
    """A static-GNN step's work bytes; over ``grid`` a rank's: a full
    graph's edge lanes and checkpointed node rows over data, the node
    tensors a layer gathers whole; a replica cell's one replica."""
    cfg, arch = cell.config, cell.arch_id
    pd = _data_ranks(grid)
    dims = steps_mod.gnn_dims(cell.shape, pd)
    n, e = dims["nodes"], dims["edges"]
    rows = n
    if cell.kind == "full_graph":
        rows, e = n // pd, e // pd
    npar, pb = _params(cell)
    out = {"gradients and AdamW": _train_state_bytes(npar, pb)
           + _grad_sums(cell, grid),
           "input layer": 2 * _f32(rows, dims["d_in"])}
    if arch == "gatedgcn":
        d = cfg.d_hidden
        out["checkpointed layer inputs"] = cfg.n_layers * _f32(rows + e, d)
        out["layer recompute and gradients"] = 2 * _f32(8 * e + 6 * n, d)
    elif arch == "pna":
        d = cfg.d_hidden
        out["checkpointed layer inputs"] = cfg.n_layers * _f32(rows, d)
        out["layer recompute and gradients"] = 2 * _f32(3 * e + 13 * n, d)
    elif arch == "schnet":
        d = cfg.d_hidden
        out["checkpointed layer inputs"] = cfg.n_interactions * _f32(rows, d)
        out["layer recompute and gradients"] = 2 * (
            _f32(e, cfg.n_rbf) + _f32(4 * e + 3 * n, d))
    elif arch == "equiformer-v2":
        irreps, c = (cfg.l_max + 1) ** 2, cfg.d_hidden
        out["checkpointed layer inputs"] = cfg.n_layers * _f32(rows, irreps,
                                                               c)
        # six (E, irreps, C) tensors: a rank's 15,840-edge replica peaked
        # 0.56 GB over five on the H100 (chip_smoke.py's ranks group)
        out["layer recompute and gradients"] = 2 * _f32(6 * e + 3 * n,
                                                        irreps, c)
    else:
        raise KeyError(arch)
    return out


def _din_work(cell, grid=None) -> dict:
    """DIN's work bytes; over ``grid`` a rank's: its rows (or candidates)
    over data, its tables' rows over model."""
    cfg = cell.config
    pd = _data_ranks(grid)
    p = 2 * cfg.embed_dim                      # an (item, category) pair
    per_row = 4 * p + sum(cfg.attn_hidden) + 1 + 3 * p   # floats
    if cell.kind == "retrieval":
        rows = min(cell.shape.dims["n_candidates"] // pd,
                   steps_mod.RETRIEVAL_CHUNK) * cfg.seq_len
        return {"one chunk's features": _f32(rows, per_row)}
    batch = cell.shape.dims["batch"]
    rows = (batch // pd if batch >= pd else batch) * cfg.seq_len
    out = {"features and attention": _f32(rows, per_row)}
    if cell.kind == "recsys_train":
        if grid is None:
            n, pb = _params(cell)
        else:
            local = {k: v for k, v in _local_leaves(cell, grid).items()
                     if k.startswith("0.")}
            pb = sum(local.values())
            n = pb // 4
        out["gradients and AdamW"] = _train_state_bytes(n, pb) \
            + _grad_sums(cell, grid)
        out["the features' gradient"] = _f32(rows, 4 * p)
    return out


def _dyngnn_work(cell, grid=None) -> dict:
    """The dyngnn step's work bytes; over ``grid`` a rank's: its steps'
    CSR pairs, its vertices' carries, its share of a block's recompute."""
    cfg, m = cell.config, cell.meta
    n, t, e = m["nodes"], m["steps"], m["edges_per_snap"]
    pd = _data_ranks(grid)
    nb = cfg.checkpoint_blocks
    widths = sum(dout for _, _, dout in cfg.layer_dims())
    carry = {"tmgcn": cfg.window - 1, "cdgcn": 2, "evolvegcn": 0}[cfg.model]
    scale = cfg.hidden / 6
    return {"CSR pairs": t // pd * 2 * (4 * (n + 1) + 8 * e),
            "block carries": nb * carry * _f32(n // pd, widths),
            "one block's recompute": int(_f32(t // nb, n)
                                         * DYNGNN_BLOCK_FLOATS[cfg.model]
                                         * scale) // pd}


def work_bytes(cell, grid=None) -> dict:
    """{term: bytes} the step holds beside its arguments at its peak (on
    one rank of ``grid``)."""
    work = {"lm": _lm_work, "gnn": _gnn_work, "recsys": _din_work,
            "dyngnn": _dyngnn_work}[cell.family](cell, grid)
    return {**work, "workspace": WORKSPACE}


def reckon(cell, capacity: int, grid=None) -> dict:
    """The cell's argument and work bytes against ``capacity``; with
    ``grid`` (the cell built over it) one rank's."""
    if grid is not None and grid.pd * grid.pm > 1:
        args = sum(_local_leaves(cell, grid).values())
    else:
        grid = None
        args = steps_mod.input_bytes(cell.abstract_inputs)
    work = work_bytes(cell, grid)
    need = args + sum(work.values()) + RESERVE
    return {"arch": cell.arch_id, "shape": cell.shape_name,
            "family": cell.family, "kind": cell.kind, "arg_bytes": args,
            "work": work, "work_bytes": sum(work.values()),
            "reserve_bytes": RESERVE, "need_bytes": need,
            "capacity_bytes": capacity, "fits": need <= capacity,
            "grid": [grid.pd, grid.pm] if grid is not None else [1, 1],
            "meta": cell.meta}


#: the largest model axis :func:`smallest_grid` tries (one node's cards)
MAX_MODEL = 8


def grid_cell(arch_id: str, shape_name: str, pd: int, pm: int,
              device: str = "cuda"):
    """The cell over a ``pd x pm`` grid stand-in (no process group: the
    specs and layout only), or None when its shapes do not split as the
    reference's specs need."""
    from repro_torch.dist.sharding import Grid
    try:
        return steps_mod.build_cell(arch_id, shape_name,
                                    Grid(pd, pm, 0, None, None),
                                    device=device)
    except ValueError:
        return None


def _stand_in(pd: int, pm: int):
    from repro_torch.dist.sharding import Grid
    return Grid(pd, pm, 0, None, None)


def smallest_grid(arch_id: str, shape_name: str, capacity: int,
                  device: str = "cuda", most: int = 4096) -> dict | None:
    """The smallest power-of-two count of cards, model axis at most
    :data:`MAX_MODEL`, at which every rank of some ``data x model`` grid
    fits ``capacity``; of the grids at that count, the one whose rank
    needs least -> its per-rank reckoning (None within ``most`` cards)."""
    n = 2
    while n <= most:
        fits = []
        m = 1
        while m <= min(n, MAX_MODEL):
            cell = grid_cell(arch_id, shape_name, n // m, m, device)
            if cell is not None:
                rec = reckon(cell, capacity, _stand_in(n // m, m))
                if rec["fits"]:
                    fits.append(rec)
            m *= 2
        if fits:
            return min(fits, key=lambda r: r["need_bytes"])
        n *= 2
    return None


def dyngnn_analytic(meta: dict, cfg, num_chips: int) -> tuple[dict, dict]:
    """Per-device flops, bytes and collective bytes of a dyngnn step
    (``repro.launch.dryrun._dyngnn_analytic``: three dense ops and the
    SpMM a layer; fwd + bwd (2x) + the checkpoint's rerun (1x); bf16
    payloads, the fused final layer's all-to-all elided)."""
    n, t, e = meta["nodes"], meta["steps"], meta["edges_per_snap"]
    p = num_chips
    dims = cfg.layer_dims()
    fwd_flops = 0.0
    for (d_in, d_gcn, d_out) in dims:
        fwd_flops += t * (2.0 * e * d_in + 2.0 * n * d_in * d_gcn)
        if cfg.model == "cdgcn":
            fwd_flops += t * 2.0 * n * (d_in + d_gcn + d_out) * 4 * d_out
        elif cfg.model == "tmgcn":
            fwd_flops += t * n * d_out * 2.0
    fwd_flops += t * 2.0 * n * dims[-1][2] * cfg.num_classes
    flops = 4.0 * fwd_flops / p
    act_bytes = 4.0 * t * n * sum(d for (_, _, d) in dims) / p
    edge_bytes = t * e * 12.0 / p
    byts = 3.0 * (act_bytes + edge_bytes) + 2 * act_bytes
    legs = 0 if cfg.model == "evolvegcn" else 2 * cfg.num_layers - 1
    avg_w = sum(d for (_, _, d) in dims) / max(len(dims), 1)
    a2a = 2 * legs * (t / p) * n * avg_w * 2.0
    coll = a2a * (p - 1) / p
    return {"flops": flops, "bytes accessed": byts}, {"total": coll}


def roofline(cost: dict, coll: dict) -> dict:
    """Seconds at the card's fp32 rate, HBM rate and NVLink rate (the
    dyngnn models are f32 on the CUDA cores)."""
    terms = {"compute_s": cost["flops"] / PEAK_FP32,
             "memory_s": cost["bytes accessed"] / HBM_BW,
             "collective_s": coll["total"] / NVLINK_BW}
    return {**terms, "dominant": max(terms, key=terms.get), "card": CARD,
            "bound_s": max(terms.values())}


def expandable_segments(on: bool) -> None:
    """Let the caching allocator grow segments in place (``on``) or not:
    a full-size cell's inputs fill most of the card, and an init's freed
    temporaries would otherwise leave gigabytes of split segments no
    large cache can use (OLMoE-1B-7B's ``long_500k`` cache did not fit
    beside them)."""
    torch.cuda.memory._set_allocator_settings(
        f"expandable_segments:{on}")


def run_step(cell, seed: int = 0) -> dict:
    """One step of ``cell`` on the card from ``make_inputs(seed)``: the
    step's ms (host clock, synchronized before and after) and the peak
    ``max_memory_allocated`` over the inputs and the step."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = obs.now_s()
    inputs = cell.make_inputs(seed, "cuda")
    torch.cuda.synchronize()
    inputs_s = obs.now_s() - t0
    t0 = obs.now_s()
    out = cell.step(*inputs)
    torch.cuda.synchronize()
    step_ms = (obs.now_s() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    # the output leaves the step computed (a decode cell's cache is its
    # input, written in place: a 17 GB isfinite would not fit beside it)
    given = {t.data_ptr() for t in steps_mod.input_leaves(inputs).values()}
    finite = all(bool(torch.isfinite(v).all())
                 for v in steps_mod.input_leaves(out).values()
                 if v.is_floating_point() and v.data_ptr() not in given)
    del inputs, out
    return {"step_ms": step_ms, "inputs_s": inputs_s, "peak_bytes": peak,
            "finite": finite}


def dry_run(cells: list[tuple[str, str]], capacity: int | None = None,
            run: bool = False, out_dir: Path | None = None,
            device: str = "cuda", log=print) -> list[dict]:
    """Reckon ``cells`` (and with ``run`` step those that fit); one record
    a cell, written to ``out_dir`` when given."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod

    if capacity is None:
        capacity = torch.cuda.get_device_properties(0).total_memory
    opened = not dist.is_initialized()
    grid = mesh_mod.join_one_rank(device)
    records = []
    if run:
        expandable_segments(True)
    try:
        for arch_id, shape_name in cells:
            cell = steps_mod.build_cell(arch_id, shape_name, grid,
                                        device=device)
            rec = reckon(cell, capacity)
            if cell.family == "dyngnn":
                cost, coll = dyngnn_analytic(cell.meta, cell.config, 1)
                rec["analytic"] = {**cost, "collective_bytes": coll["total"],
                                   "roofline": roofline(cost, coll)}
            if run and rec["fits"]:
                rec["run"] = run_step(cell)
                torch.cuda.empty_cache()
            records.append(rec)
            log(summary(rec))
            if out_dir is not None:
                out_dir.mkdir(parents=True, exist_ok=True)
                (out_dir / f"{arch_id}__{shape_name}.json").write_text(
                    json.dumps(rec, indent=2))
    finally:
        if opened:
            dist.destroy_process_group()
    return records


def summary(rec: dict) -> str:
    gb = 1e9
    top = max(rec["work"].items(), key=lambda kv: kv[1])
    grid = rec.get("grid", [1, 1])
    at = f" per rank of {grid[0]} x {grid[1]}" if grid != [1, 1] else ""
    line = (f"{rec['arch']} x {rec['shape']}{at}: "
            f"{'fits' if rec['fits'] else 'does not fit'}: arguments "
            f"{rec['arg_bytes'] / gb:.2f} GB + work "
            f"{rec['work_bytes'] / gb:.2f} GB (most: {top[0]} "
            f"{top[1] / gb:.2f}) + reserve {rec['reserve_bytes'] / gb:.2f}"
            f" = {rec['need_bytes'] / gb:.2f} of "
            f"{rec['capacity_bytes'] / gb:.2f} GB")
    if "analytic" in rec:
        rl = rec["analytic"]["roofline"]
        line += (f"; roofline {rl['bound_s'] * 1e3:.1f} ms "
                 f"({rl['dominant']})")
    if "run" in rec:
        r = rec["run"]
        line += (f"; step {r['step_ms']:.1f} ms, peak "
                 f"{r['peak_bytes'] / gb:.2f} GB, finite {r['finite']}")
    return line


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--run", action="store_true",
                    help="take one step of every cell that fits on the card")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--capacity", type=int, default=None,
                    help="bytes of one card (default: the card's "
                         "total_memory)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: reckon without a card "
                         "(needs --capacity; no --run)")
    ap.add_argument("--grid", default=None, metavar="DxM",
                    help="reckon each cell per rank of a D x M grid of "
                         "cards, and print the smallest grid for each "
                         "cell one card cannot hold (or 'fits one card')")
    args = ap.parse_args(argv)
    if args.all:
        cells = steps_mod.all_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        raise SystemExit("--arch and --shape (or --all) required")
    if args.device == "cpu" and (args.run or args.capacity is None):
        raise SystemExit("--device cpu reckons without a card: pass "
                         "--capacity BYTES and no --run")
    if args.grid:
        if args.run:
            raise SystemExit("--run steps cells on this card: drop --grid")
        pd, pm = (int(v) for v in args.grid.lower().split("x"))
        grid_run(cells, pd, pm, args.capacity, args.device)
        return
    dry_run(cells, args.capacity, args.run, Path(args.out), args.device)


def grid_run(cells: list[tuple[str, str]], pd: int, pm: int,
             capacity: int | None = None, device: str = "cuda",
             log=print) -> list[dict]:
    """``--grid``: each cell reckoned per rank of ``pd x pm`` (a cell
    whose shapes do not split there is named and skipped), and for each
    cell one card cannot hold the smallest grid that holds it ("fits one
    card" for the others)."""
    if capacity is None:
        capacity = torch.cuda.get_device_properties(0).total_memory
    records = []
    for arch_id, shape_name in cells:
        one = reckon(grid_cell(arch_id, shape_name, 1, 1, device), capacity)
        cell = grid_cell(arch_id, shape_name, pd, pm, device)
        rec = {"one_card": one}
        if cell is None:
            log(f"{arch_id} x {shape_name}: does not split over {pd} x "
                f"{pm}")
        else:
            rec["at_grid"] = reckon(cell, capacity, _stand_in(pd, pm))
            log(summary(rec["at_grid"]))
        if one["fits"]:
            log(f"{arch_id} x {shape_name}: fits one card "
                f"({one['need_bytes'] / 1e9:.2f} GB)")
        else:
            best = smallest_grid(arch_id, shape_name, capacity, device)
            rec["smallest"] = best
            log(f"{arch_id} x {shape_name}: one card needs "
                f"{one['need_bytes'] / 1e9:.2f} GB; smallest grid "
                + (f"{best['grid'][0]} x {best['grid'][1]} "
                   f"({best['grid'][0] * best['grid'][1]} cards, "
                   f"{best['need_bytes'] / 1e9:.2f} GB a rank)"
                   if best else "none within 4096 cards"))
        records.append(rec)
    return records

if __name__ == "__main__":
    main()
