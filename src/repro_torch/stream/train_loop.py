"""Per-snapshot streaming training over the delta stream.

Port of ``repro.stream.train_loop``.  Snapshots arrive one delta at a
time, the device reconstructs the padded edge list (``apply_delta``),
appends self-loops, recomputes the Laplacian weights from the
reconstructed topology (only index deltas and raw values cross the link,
paper §5.5), and runs one online train step per snapshot (or per slice of
``slice_len`` snapshots), threading the models' temporal carries across
steps.  ``advance_slice`` is that forward alone; the serving engine runs
it once per closed window.

Two loops share every step and consume the items in the same order, so
their loss streams are BIT-IDENTICAL:

* ``overlap=False`` — encode, transfer and compute interleaved on one
  thread, the copies on the compute stream;
* ``overlap=True`` — encode and transfer run on the prefetch thread,
  ``depth`` items ahead, the copies on a CUDA stream of their own.

A step differentiates one slice with ``torch.autograd.grad`` and updates
the parameters in place with the port's AdamW.  As in JAX, where the
carries are closed over by the loss, no gradient crosses a step boundary:
each step's new carries are detached, and the initial carries are clones
(``fresh_carries``), so EvolveGCN's ``w0`` — whose carry it seeds — gets
a zero gradient and is left as it was.  Each snapshot of a slice gets its
forward and transposed CSR (``build_csr_pair``) inside the step, in a
fenced ``stream.csr_pair`` span.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.core import models as mdl
from repro_torch.graph import segment
from repro_torch.kernels.segment_spmm import ops as spmm_ops
from repro_torch.optim import adamw
from repro_torch.stream import encoder as enc
from repro_torch.stream.prefetch import (DeltaApplier, PrefetchIterator,
                                         SlotStacker, stage_item)


@dataclass
class StreamTrainState:
    params: mdl.ParamTree
    opt_state: dict
    losses: list


def advance_slice(cfg: mdl.DynGNNConfig, params, carries: list,
                  frames: torch.Tensor, edges: torch.Tensor,
                  mask: torch.Tensor, values: torch.Tensor,
                  t_offset: int, csr_pairs: bool = False
                  ) -> tuple[torch.Tensor, list]:
    """One time-window of reconstructed snapshots rolls the temporal
    carries forward and yields the window's embeddings.

    frames (k, N, F), edges (k, E, 2), mask/values (k, E) -> (z (k, N, F'),
    new carries).  The serving engine (``serve.state.make_advance_step``)
    runs it once per closed window on one CSR a snapshot; the training
    steps pass ``csr_pairs=True``, which builds each snapshot's transposed
    CSR too, for the gradient."""
    n = cfg.num_nodes
    e_full, w_full = slice_weights_with_loops(
        n, *make_self_loops(n, edges.device), edges, mask, values)
    csrs = None
    if csr_pairs:
        with obs.span("stream.csr_pair", snapshots=e_full.shape[0]) as sp:
            csrs = [spmm_ops.build_csr_pair(e, w, n)
                    for e, w in zip(e_full, w_full, strict=True)]
            sp.fence(csrs[-1][1][0])
    return mdl.forward_slice(cfg, params, frames, e_full, w_full, carries,
                             t_offset, csrs)


def make_self_loops(n: int, device=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Self-loop edge list (N, 2) int32 + unit mask/values (N,) for N nodes."""
    ids = torch.arange(n, dtype=torch.int32, device=device)
    return (torch.stack([ids, ids], dim=1),
            torch.ones((n,), dtype=torch.float32, device=device))


def slice_weights_with_loops(n: int, loop_edges: torch.Tensor,
                             loop_ones: torch.Tensor, edges: torch.Tensor,
                             mask: torch.Tensor, values: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Append self-loops to a (k, E, 2) slice of reconstructed snapshots
    and recompute the per-step Laplacian weights on the device ->
    (edges (k, E + N, 2), weights (k, E + N))."""
    k = edges.shape[0]
    e_full = torch.cat([edges, loop_edges.expand(k, -1, -1)], dim=1)
    m_full = torch.cat([mask, loop_ones.expand(k, -1)], dim=1)
    v_full = torch.cat([values, loop_ones.expand(k, -1)], dim=1)
    w_full = torch.stack([segment.gcn_edge_weights(e, n, m, v)
                          for e, m, v in zip(e_full, m_full, v_full,
                                             strict=True)])
    return e_full, w_full


def slice_nll(params, z: torch.Tensor, labels: torch.Tensor
              ) -> torch.Tensor:
    """Per-(t, u) CE against the shared classifier (float32 softmax)."""
    logp = torch.log_softmax(mdl.classify(params, z).to(torch.float32),
                             dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def _tree_map(fn, tree):
    """``fn`` on every tensor of a carry (nested tuples and lists)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return fn(tree)


def fresh_carries(cfg: mdl.DynGNNConfig, params) -> list:
    """Zero carries that own their memory.

    ``init_carries`` aliases EvolveGCN's initial weight carry to the
    parameter ``w0`` itself; an in-place advance would then overwrite the
    parameter, and a step's gradient would reach it through the carry.
    Serving and the streamed trainer therefore clone the initial state
    (detached) at the start of a session or epoch, on the parameters'
    device."""
    device = params["classifier"]["u"].device
    return _tree_map(lambda t: t.detach().clone(),
                     mdl.init_carries(cfg, params, device=device))


def slice_value_and_grad(cfg: mdl.DynGNNConfig, params, carries: list,
                         frames, edges, mask, values, labels,
                         t_offset: int) -> tuple[torch.Tensor, list, list]:
    """The mean CE of one slice and its gradient -> (loss, grads in
    ``params.parameters()`` order, the new carries, detached).

    A leaf the slice does not reach (EvolveGCN's ``w0``: the carry it
    seeded holds no graph) gets a zero gradient, as ``jax.grad`` gives
    it."""
    z, new_carries = advance_slice(cfg, params, carries, frames, edges,
                                   mask, values, t_offset, csr_pairs=True)
    loss = torch.mean(slice_nll(params, z, labels))
    leaves = list(params.parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads, strict=True)]
    return loss.detach(), grads, _tree_map(torch.Tensor.detach, new_carries)


def make_stream_slice_step(cfg: mdl.DynGNNConfig,
                           opt_cfg: adamw.AdamWConfig):
    """Multi-snapshot step over a contiguous timeline slice.

    ``step(params, opt_state, carries, frames (k, N, F), edges (k, E, 2),
    mask, values (k, E), labels (k, N), t_offset) -> (params, opt_state,
    carries, loss)``: per-step Laplacian weights and both CSRs on the
    device, one ``forward_slice`` over the k-length timeline, mean CE, one
    AdamW update of ``params`` in place.  This is the single-device
    reference the snapshot-parallel streamed trainer
    (``stream.distributed``) is held to."""

    def step(params, opt_state, carries, frames, edges, mask, values,
             labels, t_offset):
        loss, grads, new_carries = slice_value_and_grad(
            cfg, params, carries, frames, edges, mask, values, labels,
            t_offset)
        params, opt_state = adamw.apply_updates(opt_cfg, params, grads,
                                                opt_state)
        return params, opt_state, new_carries, loss

    return step


def make_stream_train_step(cfg: mdl.DynGNNConfig,
                           opt_cfg: adamw.AdamWConfig):
    """Per-snapshot step: ``step(params, opt_state, carries, frame (N, F),
    edges (E, 2), mask, values (E,), labels (N,), t_offset)`` — the slice
    step over the length-1 timeline slice."""
    slice_step = make_stream_slice_step(cfg, opt_cfg)

    def step(params, opt_state, carries, frame, edges, mask, values,
             labels, t_offset):
        return slice_step(params, opt_state, carries, frame[None],
                          edges[None], mask[None], values[None],
                          labels[None], t_offset)

    return step


def host_stream(snapshots, values, frames, labels, num_nodes: int,
                max_edges: int, block_size: int,
                stats: enc.DeltaStats | None = None,
                report: enc.StreamReport | None = None):
    """Host iterator of (delta item, frame_t, labels_t) per step; each
    item's encoding in a ``stream.encode`` span (on the thread that drains
    the iterator)."""
    it = enc.iter_encode_stream(snapshots, values, num_nodes, max_edges,
                                block_size, stats, report=report)
    for t in range(len(snapshots)):
        with obs.span("stream.encode", cat="host", step=t):
            item = next(it)
        yield (item, np.asarray(frames[t]), np.asarray(labels[t]))


def default_max_edges(snapshots) -> int:
    return enc.padded_max_edges(snapshots)


def round_host_stream(step_iter, slice_len: int):
    """Group the per-step host stream into slices of ``slice_len``:
    yields (items tuple, frames (k, N, F), labels (k, N)) per round."""
    items, frs, labs = [], [], []
    for item, fr, lab in step_iter:
        items.append(item)
        frs.append(fr)
        labs.append(lab)
        if len(items) == slice_len:
            yield tuple(items), np.stack(frs), np.stack(labs)
            items, frs, labs = [], [], []
    if items:
        raise ValueError(f"trace length not divisible by slice_len="
                         f"{slice_len} ({len(items)} steps left over)")


def _staged_sync(host, device: torch.device):
    """The ``overlap=False`` loop's items: staged on the current
    stream, one at a time, in a fenced ``stream.stage`` span."""
    for x in host:
        with obs.span("stream.stage", cat="transfer") as sp:
            staged = sp.fence(stage_item(x, device))
        yield staged


def train_streamed(cfg: mdl.DynGNNConfig, snapshots, values, frames,
                   labels, *, block_size: int | None = None,
                   num_epochs: int = 1, overlap: bool = True,
                   prefetch_depth: int = 2,
                   opt_cfg: adamw.AdamWConfig | None = None,
                   params: mdl.ParamTree | None = None, opt_state=None,
                   stats: enc.DeltaStats | None = None,
                   max_edges: int | None = None,
                   slice_len: int | None = None,
                   report: enc.StreamReport | None = None,
                   step_fn=None,
                   seed: int = 0,
                   log_every: int = 10,
                   log_fn=None,
                   device: str | torch.device = "cuda"
                   ) -> StreamTrainState:
    """Stream the trace through per-snapshot training on ``device``.

    Identical-loss guarantee: for fixed inputs the returned loss sequence
    does not depend on ``overlap`` / ``prefetch_depth`` — prefetching
    moves work between threads and streams, never across the data
    dependency order.

    ``slice_len`` > 1 switches to slice-granularity online updates: each
    round reconstructs ``slice_len`` consecutive snapshots from the delta
    stream and takes ONE AdamW step on their mean CE.  ``slice_len`` in
    (None, 1) keeps the per-snapshot schedule.

    ``params`` (a ``ParamTree``, moved to ``device`` and updated in place)
    default to ``mdl.init_params`` from ``seed``.  ``step_fn`` lets
    callers that invoke this in a loop reuse one step; it must come from
    ``make_stream_train_step`` (or ``make_stream_slice_step`` when
    sliced) with matching (cfg, opt_cfg).  Each step's device phases run
    in fenced spans (``stream.apply``, ``stream.step``, and inside it
    ``stream.csr_pair``) when tracing is on.
    """
    dev = resolve_device(device)
    t_steps = len(snapshots)
    block_size = block_size or max(t_steps // max(cfg.checkpoint_blocks, 1),
                                   1)
    max_edges = max_edges or default_max_edges(snapshots)
    if stats is None:
        stats = enc.measure_stats(snapshots, cfg.num_nodes, block_size,
                                  max_edges)
    opt_cfg = opt_cfg or adamw.AdamWConfig(
        lr=1e-2, warmup_steps=10, total_steps=num_epochs * t_steps,
        weight_decay=0.0)
    if params is None:
        params = mdl.init_params(torch.Generator().manual_seed(seed), cfg)
    params = params.to(dev)
    if opt_state is None:
        opt_state = adamw.init_state(params)
    sliced = slice_len is not None and slice_len > 1
    if step_fn is None:
        step_fn = (make_stream_slice_step(cfg, opt_cfg) if sliced
                   else make_stream_train_step(cfg, opt_cfg))
    mk_host = partial(host_stream, snapshots, values, frames, labels,
                      cfg.num_nodes, max_edges, block_size, stats, report)
    if sliced and t_steps % slice_len:
        raise ValueError(f"slice_len {slice_len} must divide the trace "
                         f"length {t_steps}")

    losses: list[float] = []

    def record(loss: torch.Tensor, what: str) -> None:
        losses.append(float(loss))
        if log_fn is not None and (len(losses) - 1) % log_every == 0:
            log_fn(f"stream {what} {len(losses) - 1} loss {losses[-1]:.4f}")

    for _ in range(num_epochs):
        host = round_host_stream(mk_host(), slice_len) if sliced \
            else mk_host()
        items = (PrefetchIterator(host, depth=prefetch_depth, device=dev)
                 if overlap else _staged_sync(host, dev))
        applier = DeltaApplier(max_edges, dev)
        carries = fresh_carries(cfg, params)
        try:
            if sliced:
                stacker = SlotStacker(slice_len)
                for r, (slice_items, frame_b, lab_b) in enumerate(items):
                    with obs.span("stream.apply", step=r) as sp:
                        for j, item in enumerate(slice_items):
                            stacker.put(j, *applier.consume(item))
                        e_b, m_b, v_b = sp.fence(stacker.arrays())
                    with obs.span("stream.step", step=r) as sp:
                        params, opt_state, carries, loss = step_fn(
                            params, opt_state, carries, frame_b, e_b, m_b,
                            v_b, lab_b, r * slice_len)
                        sp.fence(loss)
                    record(loss, "slice")
            else:
                for t, (item, frame, lab) in enumerate(items):
                    with obs.span("stream.apply", step=t) as sp:
                        edges, mask, vals = sp.fence(applier.consume(item))
                    with obs.span("stream.step", step=t) as sp:
                        params, opt_state, carries, loss = step_fn(
                            params, opt_state, carries, frame, edges, mask,
                            vals, lab, t)
                        sp.fence(loss)
                    record(loss, "step")
        finally:
            # unblock + retire the prefetch worker if the step raised
            if isinstance(items, PrefetchIterator):
                items.close()
    return StreamTrainState(params=params, opt_state=opt_state,
                            losses=losses)
