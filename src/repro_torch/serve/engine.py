"""``ServeEngine`` — online inference against resident state.

Port of ``repro.serve.engine`` for the dyngnn, lm and recsys families.

* dyngnn — live CTDG events stream in through
  :class:`~repro_torch.serve.ingest.OnlineIngester`; each closed window's
  delta item is staged to the card (pinned, ``non_blocking``), applied
  into the ``DeltaApplier`` ring on the device, and one state-advance
  rolls the temporal carries forward in place; the window's node
  embeddings ``z_t`` stay cached on the device (the warm-state cache).
  Queries — node scoring or link prediction — are micro-batched reads
  against that cache: no re-encoding, no model re-run.  After window t the
  served scores equal the JAX package's on the same events and parameters
  to <=1e-5 on the CPU (``tests/test_torch_serve.py``).
* lm — prefill + greedy KV-cache decode behind ``generate()``, dense
  and MoE archs alike; each decode step's attention runs the
  ``flash_decode`` CUDA kernel on the card.  The tokens equal the JAX engine's for the same parameters and
  seed on the CPU (``tests/test_torch_lm.py``).
* recsys — batched DIN CTR scoring behind ``score()``; the logits equal
  the JAX engine's for the same parameters and seed on the CPU
  (``tests/test_torch_recsys_serve.py``).

A static-GNN arch raises the reference's ``ValueError`` (it has no
serving path).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from repro_torch import obs, resolve_device, sanitize
from repro_torch.core import models as mdl
from repro_torch.models import din, lm
from repro_torch.serve.batching import QueryBatcher
from repro_torch.serve.config import ServeConfig, ServeResult
from repro_torch.serve.ingest import OnlineIngester
from repro_torch.serve.state import (fresh_carries, make_advance_step,
                                     make_link_query_step,
                                     make_node_query_step)
from repro_torch.stream.encoder import StreamReport
from repro_torch.stream.prefetch import DeltaApplier, stage_item


def _resolve(config: ServeConfig):
    """-> (family, model config) from the registry and/or explicit model;
    an arch id resolves to its smoke config."""
    if config.model is not None:
        m = config.model
        if isinstance(m, mdl.DynGNNConfig):
            return "dyngnn", m
        if isinstance(m, lm.LMConfig):
            return "lm", m
        if isinstance(m, din.DINConfig):
            return "recsys", m
        raise ValueError(f"cannot serve a model config of type "
                         f"{type(m).__name__}; expected DynGNNConfig, "
                         "LMConfig, or DINConfig")
    from repro_torch.configs import registry
    arch = registry.get_arch(config.arch)
    if arch.family == "gnn":
        raise ValueError(
            f"arch '{config.arch}' is a static-graph gnn; online serving "
            "supports the dyngnn, lm, and recsys families")
    return arch.family, arch.make_smoke_config()


def _tree_to(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


class ServeEngine:
    """One serving session: resolved model + resident state + counters.

    ``params`` defaults to a seed-keyed fresh init on ``device``.  For
    dyngnn it is a :class:`~repro_torch.core.models.ParamTree` (e.g. from
    ``repro_torch.convert.params_from_jax``), of which the engine keeps its
    own copy; for lm the nested dict of ``init_lm_params`` (e.g. from
    ``repro_torch.convert.lm_params_from_jax``), for recsys that of
    ``din.init_params`` (e.g. from ``convert.din_params_from_jax``), moved
    to ``device``.
    ``device`` defaults to ``"cuda"`` and raises without a CUDA device
    unless ``"cpu"`` is asked for.
    """

    def __init__(self, config: ServeConfig, params=None,
                 keep_history: bool = False,
                 device: str | torch.device = "cuda"):
        config.validate()
        self.device = resolve_device(device)
        self.config = config
        self.family, self.model = _resolve(config)
        self.report = StreamReport()
        self._result = ServeResult(family=self.family, arch=config.arch)
        # scope the shared registry to this session: result() reports
        # the delta against this baseline as ServeResult.metrics
        self._metrics_base = obs.metrics_snapshot()
        self._spans_base = obs.get_tracer().recorded
        self._rng = np.random.default_rng(config.seed)
        if self.family == "dyngnn":
            self._init_dyngnn(params, keep_history)
        elif self.family == "lm":
            self._init_lm(params)
        else:
            self._init_recsys(params)

    def _family_guard(self, method: str, *families: str) -> None:
        if self.family not in families:
            raise ValueError(
                f"{method}() serves the {'/'.join(families)} family; this "
                f"engine is serving family={self.family!r}")

    # ------------------------------------------------------------ dyngnn ---
    def _init_dyngnn(self, params, keep_history: bool) -> None:
        config, cfg = self.config, self.model
        if config.ingest is None:
            raise ValueError(
                "dyngnn serving needs ServeConfig.ingest (an IngestSpec "
                "describing the live event-stream discretization)")
        # NB: the §5.4 smoothing transforms read FUTURE windows; a live
        # stream serves the raw alive-edge snapshots.
        if params is None:
            gen = torch.Generator().manual_seed(config.seed)
            params = mdl.init_params(gen, cfg)
        self.params = copy.deepcopy(params).to(self.device)
        # Resident state (carries, warm z) is single-owner by design:
        # every method touching it enters this guard, so concurrent
        # callers get an immediate RuntimeError (counted on ServeResult)
        # instead of interleaved in-place state-advances.
        self._guard = sanitize.ThreadAffinityGuard("ServeEngine")
        self.carries = fresh_carries(cfg, self.params)
        self.ingester = OnlineIngester(config.ingest, cfg.num_nodes,
                                       report=self.report,
                                       keep_history=keep_history)
        self.applier = DeltaApplier(config.ingest.max_edges, self.device)
        self._advance = make_advance_step(cfg)
        node_step, link_step = make_node_query_step(), make_link_query_step()
        self.z: torch.Tensor | None = None    # warm-state cache (N, F')
        self._node_batcher = QueryBatcher(
            lambda ids: node_step(self.params, self._warm_z(),
                                  self._to_device(ids)).cpu().numpy(),
            config.batch_sizes, config.queue_depth)
        self._link_batcher = QueryBatcher(
            lambda pairs: link_step(self.params, self._warm_z(),
                                    self._to_device(pairs)).cpu().numpy(),
            config.batch_sizes, config.queue_depth)

    def _to_device(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(rows.astype(np.int64)).to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _warm_z(self) -> torch.Tensor:
        if self.z is None:
            raise ValueError("no resident state yet: ingest events and "
                             "advance() at least one window before querying")
        return self.z

    def ingest(self, stream) -> int:
        """Push live CTDG events into the open-window buffer."""
        self._family_guard("ingest", "dyngnn")
        with self._guard:
            with obs.stopwatch("serve.ingest", cat="serve") as sw:
                n = self.ingester.push(stream)
            self._result.ingest_seconds += sw.seconds
            self._result.events_ingested = n
            # push() returns the running total -> gauge, not counter
            obs.gauge("serve.events_ingested", n)
            return n

    def advance(self, windows: int = 1) -> torch.Tensor:
        """Close ``windows`` time windows and roll the resident state.

        Each window: encode the delta on the host, stage it to the device,
        reconstruct the padded edge list in the ring, one state-advance
        (carries rolled in place), refresh the warm ``z`` cache.  With the
        tracer on, the four phases are spans (``serve.encode`` /
        ``.stage`` / ``.apply`` / ``.step``), fenced so each measures its
        device work.  Queries
        still queued against the OLD state are flushed first — the cache
        is never invalidated under a pending request.
        """
        self._family_guard("advance", "dyngnn")
        with self._guard:
            self._node_batcher.flush()
            self._link_batcher.flush()
            with obs.stopwatch("serve.advance", cat="serve",
                               windows=windows) as sw:
                for _ in range(windows):
                    t_idx = self.ingester.next_window
                    with obs.span("serve.window", cat="serve", t=t_idx):
                        with obs.span("serve.encode", cat="serve"):
                            item, frame = self.ingester.close_window()
                        with obs.span("serve.stage", cat="serve") as sp:
                            item, frame = sp.fence(
                                stage_item((item, frame), self.device))
                        with obs.span("serve.apply", cat="serve") as sp:
                            edges, mask, vals = sp.fence(
                                self.applier.consume(item))
                        with obs.span("serve.step", cat="serve") as sp:
                            self.z, self.carries = sp.fence(self._advance(
                                self.params, self.carries, frame, edges,
                                mask, vals, t_idx))
                    obs.inc("serve.windows_advanced")
                self._sync()
            self._result.ingest_seconds += sw.seconds
            self._result.windows_advanced = self.ingester.next_window
            self._result.resyncs = self.report.resyncs
            return self.z

    def advance_all(self) -> torch.Tensor:
        """Close every remaining configured window (bounded specs)."""
        self._family_guard("advance_all", "dyngnn")
        spec = self.config.ingest
        if not spec.num_windows:
            raise ValueError("advance_all() needs a bounded IngestSpec "
                             "(num_windows set); open-ended streams "
                             "advance(1) as windows elapse")
        return self.advance(spec.num_windows - self.ingester.next_window)

    def submit_nodes(self, ids):
        """Queue a node-scoring request (micro-batched; see flush())."""
        self._family_guard("submit_nodes", "dyngnn")
        with self._guard:
            self._warm_z()
            return self._node_batcher.submit(np.asarray(ids))

    def submit_links(self, pairs):
        """Queue a link-prediction request for (src, dst) pairs."""
        self._family_guard("submit_links", "dyngnn")
        with self._guard:
            self._warm_z()
            return self._link_batcher.submit(np.asarray(pairs))

    def flush(self) -> None:
        """Score everything queued (both query types)."""
        self._family_guard("flush", "dyngnn")
        with self._guard:
            self._node_batcher.flush()
            self._link_batcher.flush()

    def query_nodes(self, ids) -> np.ndarray:
        """Synchronous node scores (B, C) against resident state."""
        self._family_guard("query_nodes", "dyngnn")
        with self._guard:
            self._warm_z()
            return self._node_batcher.query(np.asarray(ids))

    def query_links(self, pairs) -> np.ndarray:
        """Synchronous link logits (B, C) against resident state."""
        self._family_guard("query_links", "dyngnn")
        with self._guard:
            self._warm_z()
            return self._link_batcher.query(np.asarray(pairs))

    def cold_query_nodes(self, ids) -> np.ndarray:
        """The no-resident-state baseline: re-encode the WHOLE ingested
        history, re-run the model over every window, then score.

        Needs ``keep_history=True``.  This is what each query would cost
        without the warm cache."""
        self._family_guard("cold_query_nodes", "dyngnn")
        cfg = self.model
        applier = DeltaApplier(self.config.ingest.max_edges, self.device)
        carries = fresh_carries(cfg, self.params)
        advance = make_advance_step(cfg)
        z = None
        for t, (item, frame) in enumerate(self.ingester.replay()):
            item, frame = stage_item((item, frame), self.device)
            edges, mask, vals = applier.consume(item)
            z, carries = advance(self.params, carries, frame, edges, mask,
                                 vals, t)
        if z is None:
            raise ValueError("no windows closed yet")
        with torch.inference_mode():
            return mdl.classify(self.params,
                                z[self._to_device(np.asarray(ids))]
                                ).cpu().numpy()

    # ---------------------------------------------------------------- lm ---
    def _init_lm(self, params) -> None:
        cfg = self.model
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.config.seed)
            params = lm.init_lm_params(gen, cfg)
        self.params = _tree_to(params, self.device)

    def generate(self, prompts=None, batch_size: int | None = None
                 ) -> np.ndarray:
        """Prefill + greedy decode one request wave -> generated tokens
        (B, max_tokens) int32.  ``prompts`` defaults to a synthetic
        (batch_size, prompt_len) wave from the seeded generator, the same
        draw as the JAX engine's.  With the tracer on, the prefill and each
        decode step are fenced spans (``serve.prefill``, ``serve.decode``).
        """
        self._family_guard("generate", "lm")
        cfg, sc = self.model, self.config
        if prompts is None:
            b = batch_size or sc.batch_sizes[-1]
            prompts = self._rng.integers(0, cfg.vocab_size,
                                         (b, sc.prompt_len))
        prompts = torch.as_tensor(np.asarray(prompts, dtype=np.int64),
                                  device=self.device)
        max_len = sc.prompt_len + sc.max_tokens
        with obs.stopwatch("serve.generate", cat="serve",
                           batch=int(prompts.shape[0])) as sw:
            with obs.span("serve.prefill", cat="serve") as sp:
                logits, cache = sp.fence(lm.prefill(cfg, self.params,
                                                    prompts, max_len))
                tok = torch.argmax(logits, -1)
            out = [tok]
            for _ in range(sc.max_tokens - 1):
                with obs.span("serve.decode", cat="serve") as sp:
                    logits, cache = sp.fence(lm.decode_step(
                        cfg, self.params, cache, tok))
                    tok = torch.argmax(logits, -1)
                out.append(tok)
            tokens = torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
        dt = sw.seconds
        r = self._result
        r.queries += int(prompts.shape[0])
        r.query_batches += 1
        r.tokens_generated += tokens.size
        r.query_seconds += dt
        r.query_latencies_ms.append(dt * 1e3)
        obs.inc("serve.queries", int(prompts.shape[0]))
        obs.inc("serve.tokens_generated", tokens.size)
        return tokens

    # ------------------------------------------------------------ recsys ---
    def _init_recsys(self, params) -> None:
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.config.seed)
            params = din.init_params(gen, self.model)
        self.params = _tree_to(params, self.device)

    def synthetic_requests(self, batch_size: int) -> dict:
        """One synthetic CTR request batch from the seeded generator (the
        JAX engine's draws), as tensors on the engine's device."""
        return din.batch_to(din.synthetic_requests(self._rng, self.model,
                                                   batch_size), self.device)

    def score(self, batch: dict | None = None,
              batch_size: int | None = None) -> np.ndarray:
        """Batched CTR logits (B, C) for one request wave; ``batch``
        defaults to ``synthetic_requests(batch_size)``."""
        self._family_guard("score", "recsys")
        if batch is None:
            batch = self.synthetic_requests(
                batch_size or self.config.batch_sizes[-1])
        with obs.stopwatch("serve.score", cat="serve") as sw:
            with torch.inference_mode():
                scores = din.forward(self.params, batch).cpu().numpy()
        dt = sw.seconds
        r = self._result
        r.queries += int(scores.shape[0])
        r.query_batches += 1
        r.query_seconds += dt
        r.query_latencies_ms.append(dt * 1e3)
        obs.inc("serve.queries", int(scores.shape[0]))
        return scores

    # ------------------------------------------------------------ result ---
    def result(self) -> ServeResult:
        """Session counters so far (flushes pending dyngnn queries)."""
        r = self._result
        if self.family == "dyngnn":
            with self._guard:
                self._node_batcher.flush()
                self._link_batcher.flush()
            r.guard_trips = self._guard.trips
            r.queries = (self._node_batcher.stats.queries
                         + self._link_batcher.stats.queries)
            r.query_batches = (self._node_batcher.stats.batches
                               + self._link_batcher.stats.batches)
            r.query_seconds = (self._node_batcher.stats.seconds
                               + self._link_batcher.stats.seconds)
            r.query_latencies_ms = (self._node_batcher.stats.latencies_ms
                                    + self._link_batcher.stats.latencies_ms)
            r.events_ingested = self.ingester.events_ingested
            r.resyncs = self.report.resyncs
        trc = obs.get_tracer()
        r.metrics = obs.metrics().delta(self._metrics_base)
        r.metrics["spans"] = trc.summary(trc.spans_since(self._spans_base))
        return r


def serve(config: ServeConfig, params=None, **kwargs) -> ServeEngine:
    """``serve(ServeConfig(arch=...))`` -> ready engine."""
    return ServeEngine(config, params=params, **kwargs)
