"""The generator: snapshot t is the same whoever makes it; features,
labels and padding follow the port's host pipeline."""

import numpy as np
import pytest
import torch

from perfbench import gen
from perfbench.reference import common

BIG = 2**31 + 987_654_321          # seeds pass 32 signed bits


def test_snapshot_is_the_same_for_a_rank_and_the_reference(tiny):
    from repro_torch.dist.sharding import ShardLayout

    traffic = dict(tiny, ranks=4)
    layout = ShardLayout(rank=2, world=4, nb=2, bsize=8,
                         num_nodes=traffic["nodes"])
    for t in layout.steps:
        mine = gen.raw_edges(BIG, t, traffic, "cpu")
        src, dst, _, _, _ = common.snapshot_graph(BIG, t, traffic, "cpu")
        e = traffic["edges_per_snapshot"]
        assert torch.equal(mine[0], src[:e]) and torch.equal(mine[1], dst[:e])


def test_snapshots_differ_by_step_and_seed(tiny):
    a = gen.raw_edges(BIG, 3, tiny, "cpu")
    assert not torch.equal(a, gen.raw_edges(BIG, 4, tiny, "cpu"))
    assert not torch.equal(a, gen.raw_edges(BIG + 1, 3, tiny, "cpu"))
    assert torch.equal(a, gen.raw_edges(BIG, 3, tiny, "cpu"))


@pytest.mark.parametrize("n", [40, 41])
def test_features_and_labels_follow_the_port_recipe(tiny, n):
    from repro_torch.data.dyngnn import dataset_from_snapshots

    traffic = dict(tiny, nodes=n)
    raws = [gen.raw_edges(7, t, traffic, "cpu") for t in range(4)]
    ds = dataset_from_snapshots([r.T.numpy() for r in raws], n)
    for t, raw in enumerate(raws):
        frame, labels = gen.features_and_labels(raw, n)
        np.testing.assert_array_equal(frame.numpy(), ds.frames[t])
        np.testing.assert_array_equal(labels.numpy(), ds.labels[t])


def test_padded_lanes_match_build_batch(tiny):
    from repro_torch.core.dtdg import build_batch

    raw = gen.raw_edges(5, 0, tiny, "cpu")
    edges, mask = gen.padded_lanes(raw, tiny)
    n = tiny["nodes"]
    frame, _ = gen.features_and_labels(raw, n)
    b = build_batch([raw.T.numpy()], frame[None].numpy(), n,
                    max_edges=gen.lanes(tiny), device="cpu")
    assert torch.equal(edges, b.edges[0]) and torch.equal(mask, b.edge_mask[0])
    assert gen.lanes(tiny) % 128 == 0


def test_params_are_drawn_from_the_seed():
    shapes = [("a", (2, 3), 0.5), ("b", (3,), 0.0)]
    p = gen.make_params(BIG, shapes, "cpu")
    q = gen.make_params(BIG, shapes, "cpu")
    assert torch.equal(p["a"], q["a"]) and not p["b"].any()
    assert float(p["a"].abs().max()) <= 0.5
    assert not torch.equal(p["a"], gen.make_params(BIG + 1, shapes, "cpu")["a"])
