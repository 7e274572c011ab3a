"""SamplingSpec: the declarative knobs of the sampled schedule.

A copy of ``repro.hoststore.spec`` (stdlib only), in its own leaf module
so ``run/plan.py`` can import and validate it without pulling the host
store into plan construction.
"""

from __future__ import annotations

from dataclasses import dataclass


def _round_up(v: int, m: int) -> int:
    return max(((v + m - 1) // m) * m, m)


@dataclass(frozen=True)
class ResolvedSampling:
    """Static shapes one sampled round stages (derived once per run).

    ``num_seeds`` seed lanes lead the round node table; ``table_pad``
    (a multiple of the shard count — the temporal all-to-alls run over
    the TABLE axis) is the per-round node budget; ``edge_pad`` the
    per-snapshot budget for the deduplicated union subgraph.
    """

    num_seeds: int
    table_pad: int
    edge_pad: int


@dataclass(frozen=True)
class SamplingSpec:
    """Fanout-sampling knobs of ``schedule="sampled"``.

    * ``batch_nodes`` — seed vertices drawn per round (clamped to N;
      ``batch_nodes >= N`` means every vertex is a seed every round —
      the full-fanout equivalence regime);
    * ``fanouts`` — per-hop in-neighbor fanout, outermost layer first;
      a fanout >= the max in-degree samples the full neighborhood;
    * ``seed`` — host-sampler PRNG seed (independent of the param-init
      seed: the same model can train over different sample streams);
    * ``table_pad`` / ``max_edges`` — optional static-budget overrides
      for the round node table / per-snapshot union edges.  ``None``
      derives the worst-case closed-neighborhood bound (tight for small
      graphs, loose for big ones — real runs should cap it; overflowing
      a cap degrades to dropped lanes counted on ``SampleReport``);
    * ``workers`` — host sampling threads per round.
    """

    batch_nodes: int
    fanouts: tuple[int, ...] = (10, 10)
    seed: int = 0
    table_pad: int | None = None
    max_edges: int | None = None
    workers: int = 4

    def validate(self) -> None:
        if self.batch_nodes < 1:
            raise ValueError(f"sampling.batch_nodes must be >= 1, got "
                             f"{self.batch_nodes}")
        if not self.fanouts or any(f < 1 for f in self.fanouts):
            raise ValueError(f"sampling.fanouts must be non-empty positive "
                             f"ints, got {self.fanouts!r}")
        if self.workers < 1:
            raise ValueError("sampling.workers must be >= 1")
        if self.table_pad is not None and self.table_pad < 1:
            raise ValueError("sampling.table_pad must be >= 1")
        if self.max_edges is not None and self.max_edges < 1:
            raise ValueError("sampling.max_edges must be >= 1")

    def worst_case_nodes(self, win: int) -> int:
        """Closed-neighborhood bound on the round table: every sampled
        edge of every owned step could introduce a new vertex."""
        b = self.batch_nodes
        per_step = 0
        cap = b
        for f in self.fanouts:
            cap *= f
            per_step += cap
        return b + win * per_step

    def worst_case_edges(self) -> int:
        """Per-step bound on the deduplicated union subgraph."""
        total, cap = 0, self.batch_nodes
        for f in self.fanouts:
            cap *= f
            total += cap
        return total

    def resolve(self, num_nodes: int, win: int,
                num_shards: int) -> ResolvedSampling:
        """Derive the static round shapes for a concrete run.

        The node table is bounded by N (a sample can never exceed the
        vertex set) and padded to a multiple of the shard count so the
        vertex-sharded temporal stage tiles it exactly.
        """
        self.validate()
        num_seeds = min(self.batch_nodes, num_nodes)
        table = self.table_pad
        if table is None:
            table = min(self.worst_case_nodes(win), num_nodes)
        table = max(table, num_seeds)
        table = _round_up(table, num_shards)
        edges = self.max_edges
        if edges is None:
            edges = self.worst_case_edges()
        edges = _round_up(edges, 128)
        return ResolvedSampling(num_seeds=num_seeds, table_pad=table,
                                edge_pad=edges)
