"""The port's host-side stream code and on-device delta apply, held to the
JAX package.

* the copied numpy modules (CTDG bridging, generators, encoder, online
  ingester) give byte-identical output to their ``repro`` originals;
* ``apply_delta`` reconstructs exactly the JAX edge lists and masks over
  whole streams, including drops at position 0 and full buffers;
* the ``DeltaApplier`` ring gives the same snapshots as the JAX ring
  across 2 x block_size windows (every slot reused several times).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ctdg as jctdg
from repro.core import graphdiff as jgd
from repro.graph import generate as jgen
from repro.serve import IngestSpec as JSpec
from repro.serve import OnlineIngester as JIngester
from repro.stream import encoder as jenc
from repro.stream.prefetch import DeltaApplier as JApplier
from repro.stream.prefetch import stage_item as jstage
from repro_torch.core import ctdg
from repro_torch.core import graphdiff as gd
from repro_torch.graph import generate
from repro_torch.serve import IngestSpec, OnlineIngester
from repro_torch.stream import encoder as enc
from repro_torch.stream.prefetch import DeltaApplier, stage_item

N, W = 40, 12


def _assert_items_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in a.__dataclass_fields__:
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype
            np.testing.assert_array_equal(va, vb)
        else:
            assert va == vb


def _both_streams(seed, events=400):
    s = jctdg.synthetic_ctdg(N, events, delete_frac=0.25, seed=seed)
    t = ctdg.synthetic_ctdg(N, events, delete_frac=0.25, seed=seed)
    return s, t


# ------------------------------------------------ byte-identical copies -----

@pytest.mark.parametrize("seed", [0, 4])
def test_ctdg_and_generators_byte_identical(seed):
    s, t = _both_streams(seed)
    for f in ("src", "dst", "time", "kind"):
        a, b = getattr(s, f), getattr(t, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for fn in ("snapshot_events", "window_events"):
        for a, b in zip(getattr(jctdg, fn)(s, W), getattr(ctdg, fn)(t, W)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        jctdg.uniform_bounds(0.0, 1.0, W), ctdg.uniform_bounds(0.0, 1.0, W))
    for a, b in zip(jgen.evolving_dynamic_graph(N, 5, 3.0, 0.2, seed),
                    generate.evolving_dynamic_graph(N, 5, 3.0, 0.2, seed)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(jgen.degree_features(a, N),
                                      generate.degree_features(b, N))
    for a, b in zip(jgen.random_dynamic_graph(N, 3, 2.0, seed),
                    generate.random_dynamic_graph(N, 3, 2.0, seed)):
        np.testing.assert_array_equal(a, b)


def test_encoder_items_byte_identical_and_stats():
    snaps = generate.evolving_dynamic_graph(N, 10, 3.0, churn=0.3, seed=2)
    max_edges = enc.padded_max_edges(snaps)
    assert max_edges == jenc.padded_max_edges(snaps)
    stats = enc.measure_stats(snaps, N, 4, max_edges)
    jstats = jenc.measure_stats(snaps, N, 4, max_edges)
    assert (stats.max_drops, stats.max_adds, stats.churn_pad) == \
        (jstats.max_drops, jstats.max_adds, jstats.churn_pad)
    # tight pads force overflow resyncs on some steps: both must agree
    for pad in (stats.max_drops, 8):
        rep, jrep = enc.StreamReport(), jenc.StreamReport()
        ours = enc.IncrementalEncoder(N, max_edges, 4, pad, pad, report=rep)
        theirs = jenc.IncrementalEncoder(N, max_edges, 4, pad, pad,
                                         report=jrep)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            for snap in snaps:
                _assert_items_equal(ours.encode(snap), theirs.encode(snap))
        assert rep.resync_steps == jrep.resync_steps
        assert (rep.resyncs > 0) == (pad == 8)
    # the whole-trace encoders (the training pipeline's byte accounting)
    vals = [np.arange(len(sn), dtype=np.float32) for sn in snaps]
    for v in (None, vals):
        ours = list(enc.iter_encode_stream(snaps, v, N, max_edges, 4))
        theirs = jenc.encode_stream_fast(snaps, v, N, max_edges, 4)
        assert len(ours) == len(theirs) == len(snaps)
        for a, b in zip(ours, theirs):
            _assert_items_equal(a, b)
            assert a.payload_bytes == b.payload_bytes
        for a, b in zip(enc.encode_stream_fast(snaps, v, N, max_edges, 4,
                                               stats), theirs):
            _assert_items_equal(a, b)


def test_encoder_rejects_unported_wire():
    """The reference's two wires are ported (``int8``'s items are held to
    JAX's in ``tests/test_torch_dist_stream.py``); any other is refused,
    as the reference refuses it."""
    assert enc.IncrementalEncoder(N, 64, 4, 64, 64, wire="int8").wire == \
        "int8"
    with pytest.raises(ValueError, match="wire must be one of"):
        enc.IncrementalEncoder(N, 64, 4, 64, 64, wire="int4")


@pytest.mark.parametrize("policy", ["snapshot", "window"])
@pytest.mark.parametrize("seed", [0, 3])
def test_ingester_items_and_frames_byte_identical(policy, seed):
    s, t = _both_streams(seed)
    spec = dict(num_windows=W, policy=policy,
                time_range=(float(s.time.min()), float(s.time.max())),
                block_size=4, max_edges=512)
    ours, theirs = OnlineIngester(IngestSpec(**spec), N), \
        JIngester(JSpec(**spec), N)
    for lo in range(0, len(s), 97):
        sl = slice(lo, lo + 97)
        ours.push(ctdg.EventStream(t.src[sl], t.dst[sl], t.time[sl],
                                   t.kind[sl], N))
        theirs.push(jctdg.EventStream(s.src[sl], s.dst[sl], s.time[sl],
                                      s.kind[sl], N))
    for _ in range(W):
        (a, fa), (b, fb) = ours.close_window(), theirs.close_window()
        _assert_items_equal(a, b)
        np.testing.assert_array_equal(fa, fb)


# ----------------------------------------------------------- apply_delta ----

def _check_apply(prev_e, prev_m, dp, dm, ae, am):
    want_e, want_m = jax.jit(jgd.apply_delta)(
        jnp.asarray(prev_e), jnp.asarray(prev_m), jnp.asarray(dp),
        jnp.asarray(dm), jnp.asarray(ae), jnp.asarray(am))
    got_e, got_m = gd.apply_delta(*(torch.from_numpy(a) for a in
                                    (prev_e, prev_m, dp, dm, ae, am)))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    return got_e.numpy(), got_m.numpy()


def test_apply_delta_exact_over_a_stream():
    snaps = generate.evolving_dynamic_graph(N, 12, 3.0, churn=0.3, seed=5)
    max_edges = enc.padded_max_edges(snaps)
    inc = enc.IncrementalEncoder(N, max_edges, 6, max_edges, max_edges)
    e = m = None
    for snap in snaps:
        item = inc.encode(snap)
        if isinstance(item, gd.FullSnapshot):
            e, m = item.edges, item.mask
            continue
        e, m = _check_apply(e, m, item.drop_pos, item.drop_mask,
                            item.add_edges, item.add_mask)
        assert int(m.sum()) == snap.shape[0]


def test_apply_delta_drop_at_position_zero_and_full_buffer():
    e_max = 16
    rng = np.random.default_rng(0)
    prev_e = rng.integers(1, N, (e_max, 2)).astype(np.int32)
    prev_m = np.ones(e_max, np.float32)            # a full buffer
    dp = np.zeros(e_max, np.int32)
    dm = np.zeros(e_max, np.float32)
    dp[:3], dm[:3] = [0, 5, 15], 1.0               # drop position 0 + last
    ae = rng.integers(0, N, (e_max, 2)).astype(np.int32)
    am = np.zeros(e_max, np.float32)
    am[:5] = 1.0                                   # 2 adds overflow: dropped
    e, m = _check_apply(prev_e, prev_m, dp, dm, ae, am)
    assert m.sum() == e_max
    # nothing dropped, adds past the end of a full buffer vanish
    _check_apply(prev_e, prev_m, np.zeros(e_max, np.int32),
                 np.zeros(e_max, np.float32), ae, am)
    # everything dropped: buffer empties to edge (0, 0), then refills
    _check_apply(prev_e, prev_m, np.arange(e_max, dtype=np.int32),
                 np.ones(e_max, np.float32), ae, am)


def test_delta_applier_ring_reuse_matches_jax():
    block = 3
    snaps = generate.evolving_dynamic_graph(N, 2 * block + 2, 3.0,
                                            churn=0.25, seed=9)
    max_edges = enc.padded_max_edges(snaps)
    inc = enc.IncrementalEncoder(N, max_edges, block, max_edges, max_edges)
    jinc = jenc.IncrementalEncoder(N, max_edges, block, max_edges,
                                   max_edges)
    ours = DeltaApplier(max_edges, device="cpu")
    theirs = JApplier(max_edges, donate=False)
    for snap in snaps:
        e, m, v = ours.consume(stage_item(inc.encode(snap), "cpu"))
        je, jm, jv = theirs.consume(jstage(jinc.encode(snap)))
        np.testing.assert_array_equal(e.numpy(), np.asarray(je))
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        assert e.data_ptr() in (ours._edges[0].data_ptr(),
                                ours._edges[1].data_ptr())


def test_stage_item_keeps_dtypes_and_shapes():
    snaps = generate.evolving_dynamic_graph(N, 2, 3.0, seed=1)
    inc = enc.IncrementalEncoder(N, 128, 4, 128, 128)
    for snap in snaps:
        item = inc.encode(snap)
        staged, frame = stage_item((item, generate.degree_features(snap, N)),
                                   "cpu")
        for f in item.__dataclass_fields__:
            a = getattr(item, f)
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(getattr(staged, f).numpy(), a)
        assert frame.dtype == torch.float32 and frame.shape == (N, 2)
