"""Data sources: the *what* of a training run (port of ``repro.run.data``).

A :class:`DataSource` yields a ``DTDGDataset``; the Engine asks it to build
and owns nothing else.  Ported: :class:`SyntheticTrace` (the evolving
synthetic DTDG generator as a declarative spec) and :class:`InMemoryDTDG`
(an already-built dataset).  The reference's ``EdgeListDTDG`` (timestamped
edge-list files) is not ported yet (ROADMAP Queue 1, item 8d).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.data.dyngnn import (DTDGDataset, DTDGPipeline,
                                     synthetic_dataset)


@runtime_checkable
class DataSource(Protocol):
    """Anything that can build a ``DTDGDataset`` on demand.

    ``num_nodes`` is the source's nominal vertex count; ``build(num_nodes=
    n)`` must honor an override >= the nominal count (vertex-axis padding).
    """

    num_nodes: int | None

    def build(self, num_nodes: int | None = None) -> DTDGDataset:
        ...


def pad_dataset(ds: DTDGDataset, num_nodes: int) -> DTDGDataset:
    """Append isolated vertices (zero features, class-0 labels) up to
    ``num_nodes``.  The edge lists (and so the trained graph) are
    untouched."""
    if num_nodes == ds.num_nodes:
        return ds
    if num_nodes < ds.num_nodes:
        raise ValueError(f"cannot shrink dataset from {ds.num_nodes} to "
                         f"{num_nodes} nodes")
    t = ds.frames.shape[0]
    extra = num_nodes - ds.num_nodes
    frames = np.concatenate(
        [ds.frames, np.zeros((t, extra, ds.frames.shape[2]),
                             dtype=ds.frames.dtype)], axis=1)
    labels = np.concatenate(
        [ds.labels, np.zeros((t, extra), dtype=ds.labels.dtype)], axis=1)
    return DTDGDataset(snapshots=ds.snapshots, values=ds.values,
                       frames=frames, labels=labels, num_nodes=num_nodes)


@dataclass(frozen=True)
class SyntheticTrace:
    """Spec for ``repro_torch.data.dyngnn.synthetic_dataset``.

    A ``num_nodes`` override pads the nominal trace with isolated
    vertices (same graph, same labels).
    """

    num_nodes: int
    num_steps: int
    density: float = 3.0
    churn: float = 0.1
    smoothing_mode: str = "none"    # none | mproduct | edgelife
    window: int = 5
    edge_life: int = 5
    seed: int = 0

    def build(self, num_nodes: int | None = None) -> DTDGDataset:
        ds = synthetic_dataset(
            self.num_nodes, self.num_steps, density=self.density,
            churn=self.churn, smoothing_mode=self.smoothing_mode,
            window=self.window, edge_life=self.edge_life, seed=self.seed)
        if num_nodes is not None:
            ds = pad_dataset(ds, num_nodes)
        return ds


@dataclass
class InMemoryDTDG:
    """Wrap an existing ``DTDGDataset`` (and optionally its pipeline)."""

    ds: DTDGDataset
    pipeline: DTDGPipeline | None = None

    @property
    def num_nodes(self) -> int:
        return self.ds.num_nodes

    def build(self, num_nodes: int | None = None) -> DTDGDataset:
        if num_nodes is None:
            return self.ds
        return pad_dataset(self.ds, num_nodes)
