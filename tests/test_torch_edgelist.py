"""The port's edge-list data (``repro_torch.run.data``) held to the JAX
package's (``repro.run.data``).

The readers, the writer and the out-of-core path are host numpy copied
from the reference, so the port must give the same bytes and the same
snapshots:

* ``write_edgelist``: the same ``.tsv`` bytes; the same ``.npz`` members,
  byte for byte (the archive's own member timestamps are the clock's);
* ``read_edgelist``, in memory and with ``chunk_edges``: the reference's
  snapshots (values and dtypes) and vertex count, on files either package
  wrote, on the committed KONECT-format fixture, on empty boundary and
  mid-trace snapshots, and on a deflated archive;
* the same refusals with the same messages; ``_npz_memmaps`` maps the
  members (``np.memmap``), not loads them;
* ``EdgeListDTDG.build`` equals the reference's dataset array for array,
  padding included (it keeps the real vertices' labels);
* ``Engine`` fits over an ``EdgeListDTDG``, eager and ``sampled``, equal
  the JAX Engine's from the same parameters: losses at rtol 1e-5,
  parameters at 1e-6 (``tests/test_torch_hoststore.py``'s tolerances).
"""

import zipfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch.distributed as dist

from repro.core import models as jm
from repro.graph import generate as jgen
from repro.hoststore import SamplingSpec as JSpec
from repro.run import EdgeListDTDG as JEdgeList
from repro.run import Engine as JEngine
from repro.run import ExecutionPlan as JPlan
from repro.run import RunConfig as JRunConfig
from repro.run import data as jrdata
from repro_torch import convert
from repro_torch.core import models as tm
from repro_torch.run import (EdgeListDTDG, Engine, ExecutionPlan, RunConfig,
                             SamplingSpec, read_edgelist, write_edgelist)
from repro_torch.run import data as rdata

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "epinions_tiny.tsv"
N, T, NB, W = 48, 16, 2, 3
EXTS = ["tsv", "npz"]
CHUNKS = (1, 13, 10_000)


def _silent(_msg):
    return None


def _snaps(n=N, t=8, seed=3, empty=()):
    snaps = jgen.evolving_dynamic_graph(n, t, density=2.0, churn=0.2,
                                        seed=seed)
    for i in empty:
        snaps[i] = np.zeros((0, 2), dtype=np.int32)
    return snaps


def _same_snaps(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def _same_dataset(got, want):
    assert got.num_nodes == want.num_nodes
    _same_snaps(got.snapshots, want.snapshots)
    if want.values is None:
        assert got.values is None
    else:
        _same_snaps(got.values, want.values)
    for name in ("frames", "labels"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _members(path) -> dict:
    with zipfile.ZipFile(path) as z:
        return {zi.filename: (zi.compress_type, z.read(zi))
                for zi in z.infolist()}


# ------------------------------------------------------------ writers -------

@pytest.mark.parametrize("ext", EXTS)
def test_write_edgelist_gives_the_reference_bytes(tmp_path, ext):
    snaps = _snaps(empty=(0, 3, 7))
    mine, ref = tmp_path / f"port.{ext}", tmp_path / f"ref.{ext}"
    write_edgelist(mine, snaps)
    jrdata.write_edgelist(ref, snaps)
    if ext == "tsv":
        assert mine.read_bytes() == ref.read_bytes()
    else:
        assert _members(mine) == _members(ref)


# ------------------------------------------------------------ readers -------

@pytest.mark.parametrize("ext", EXTS)
def test_read_edgelist_matches_the_reference_in_memory_and_chunked(tmp_path,
                                                                   ext):
    """Files written by either package read back as the generator's lists
    and as the reference reads them, at every chunk size (an empty
    mid-trace snapshot and empty boundary snapshots included)."""
    snaps = _snaps(empty=(0, 2, 7))
    for writer in (write_edgelist, jrdata.write_edgelist):
        path = tmp_path / f"{writer.__module__}.{ext}"
        writer(path, snaps)
        want, n_want = jrdata.read_edgelist(path)
        got, n_got = read_edgelist(path)
        _same_snaps(want, [s.astype(np.int32) for s in snaps])
        _same_snaps(got, want)
        assert n_got == n_want <= N
        for chunk in CHUNKS:
            got, n_got = read_edgelist(path, chunk_edges=chunk)
            want_c, n_c = jrdata.read_edgelist(path, chunk_edges=chunk)
            _same_snaps(got, want)
            _same_snaps(want_c, want)
            assert n_got == n_c == n_want


def test_read_edgelist_without_the_marker_bins_the_span(tmp_path):
    """A file with no ``num_steps`` marker bins over [t.min(), t.max()]:
    the inner empty bin stays, the outer ones cannot be known."""
    p = tmp_path / "ext.tsv"
    p.write_text("# external\n0 1 5\n2 3 5\n4 0 7\n1 1 7\n")
    want, n_want = jrdata.read_edgelist(p)
    assert len(want) == 3 and want[1].shape == (0, 2)
    got, n_got = read_edgelist(p)
    _same_snaps(got, want)
    assert n_got == n_want == 5
    for chunk in (1, 3):
        got, _ = read_edgelist(p, chunk_edges=chunk)
        _same_snaps(got, want)


def test_the_committed_fixture_reads_and_builds_as_the_reference():
    """``tests/fixtures/epinions_tiny.tsv`` (KONECT's format, with the
    ``num_steps`` marker): the same snapshots in memory and chunked, and
    the same TM-GCN dataset."""
    want, n_want = jrdata.read_edgelist(FIXTURE)
    got, n_got = read_edgelist(FIXTURE)
    assert (len(want), n_want) == (8, 24)
    _same_snaps(got, want)
    assert n_got == n_want
    got, _ = read_edgelist(FIXTURE, chunk_edges=5)
    _same_snaps(got, want)
    kw = {"smoothing_mode": "mproduct", "window": W}
    _same_dataset(EdgeListDTDG(str(FIXTURE), **kw).build(),
                  JEdgeList(str(FIXTURE), **kw).build())


@pytest.mark.parametrize("ext", EXTS)
def test_empty_boundary_snapshots_survive_the_round_trip(tmp_path, ext):
    core = jgen.evolving_dynamic_graph(16, 4, density=2.0, seed=1)
    empty = np.zeros((0, 2), dtype=np.int32)
    snaps = [empty] + core + [empty]
    path = tmp_path / f"trace.{ext}"
    write_edgelist(path, snaps)
    for chunk in (None, 3):
        got, _ = read_edgelist(path, chunk_edges=chunk)
        assert len(got) == 6
        _same_snaps(got, jrdata.read_edgelist(path, chunk_edges=chunk)[0])
        _same_snaps(got, snaps)


@pytest.mark.parametrize("smoothing", ["none", "mproduct", "edgelife"])
def test_edgelist_source_builds_the_reference_dataset(tmp_path, smoothing):
    """``EdgeListDTDG.build`` (in memory and chunked, padded and not)
    equals the reference's array for array; padding appends isolated
    vertices after the labels are derived, so the real ones keep theirs."""
    snaps = _snaps(n=30, t=6, seed=5)
    path = tmp_path / "t.npz"
    jrdata.write_edgelist(path, snaps)
    kw = {"num_nodes": 30, "smoothing_mode": smoothing, "window": W}
    want = JEdgeList(str(path), **kw).build()
    for chunk in (None, 7):
        got = EdgeListDTDG(str(path), chunk_edges=chunk, **kw).build()
        _same_dataset(got, want)
    padded = EdgeListDTDG(str(path), **kw).build(num_nodes=32)
    _same_dataset(padded, JEdgeList(str(path), **kw).build(num_nodes=32))
    assert padded.num_nodes == 32
    np.testing.assert_array_equal(padded.labels[:, :30], want.labels)
    np.testing.assert_array_equal(padded.frames[:, :30], want.frames)
    assert not padded.frames[:, 30:].any()
    with pytest.raises(ValueError, match="shrink"):
        EdgeListDTDG(str(path), **kw).build(num_nodes=29)


# ----------------------------------------------------------- refusals -------

def _bad_files(tmp_path) -> dict:
    """name -> (path, EdgeListDTDG kwargs, read kwargs): inputs the
    reference refuses."""
    files = {}
    p = tmp_path / "cols.tsv"
    p.write_text("# src dst\n0\t1\n2\t3\n")
    files["columns"] = (p, {}, {})
    p = tmp_path / "big.tsv"
    jrdata.write_edgelist(p, [np.array([[0, 5]], dtype=np.int32)])
    files["node ids up to"] = (p, {"num_nodes": 3}, {})
    p = tmp_path / "neg.tsv"
    p.write_text("0 -1 0\n1 2 0\n")
    files["negative node ids"] = (p, {}, {})
    p = tmp_path / "empty.npz"
    none = np.zeros((0,), dtype=np.int64)
    np.savez(p, src=none, dst=none, t=none)
    files["empty edge list"] = (p, {}, {})
    p = tmp_path / "late.npz"
    np.savez(p, src=np.array([0, 1]), dst=np.array([1, 0]),
             t=np.array([0, 4]), num_steps=np.int64(3))
    files["outside the declared"] = (p, {}, {})
    p = tmp_path / "chunk.tsv"
    jrdata.write_edgelist(p, _snaps(t=2))
    files["chunk_edges must be"] = (p, {}, {"chunk_edges": 0})
    return files


@pytest.mark.parametrize("match", ["columns", "node ids up to",
                                   "negative node ids", "empty edge list",
                                   "outside the declared",
                                   "chunk_edges must be"])
def test_bad_files_are_refused_with_the_reference_message(tmp_path, match):
    path, src_kw, read_kw = _bad_files(tmp_path)[match]
    chunked = [None, 1] if not read_kw else [read_kw["chunk_edges"]]
    if match == "columns":
        chunked = [None, 2]
    for chunk in chunked:
        with pytest.raises(ValueError) as want:
            JEdgeList(str(path), chunk_edges=chunk, **src_kw).build()
        with pytest.raises(ValueError) as got:
            EdgeListDTDG(str(path), chunk_edges=chunk, **src_kw).build()
        assert str(got.value) == str(want.value)
        assert match in str(got.value)


# ------------------------------------------------------ out of core ---------

def test_out_of_core_npz_is_memmapped_and_deflated_falls_back(tmp_path):
    """Uncompressed members are mapped straight out of the archive (a
    ``np.memmap``, equal to the reference's map); a deflated archive has
    nothing to map and reads through the regular load, same snapshots."""
    snaps = _snaps(n=24, t=4, seed=2)
    p = tmp_path / "trace.npz"
    write_edgelist(p, snaps)
    mm, jmm = rdata._npz_memmaps(p), jrdata._npz_memmaps(p)
    assert sorted(mm) == sorted(jmm) == ["dst", "num_steps", "src", "t"]
    for k in mm:
        assert isinstance(mm[k], np.memmap)
        assert mm[k].offset == jmm[k].offset and mm[k].dtype == jmm[k].dtype
        np.testing.assert_array_equal(np.asarray(mm[k]), np.asarray(jmm[k]))
    np.testing.assert_array_equal(np.asarray(mm["src"]),
                                  np.concatenate([s[:, 0] for s in snaps]))
    src = np.concatenate([s[:, 0] for s in snaps]).astype(np.int64)
    dst = np.concatenate([s[:, 1] for s in snaps]).astype(np.int64)
    t = np.concatenate([np.full(s.shape[0], i, np.int64)
                        for i, s in enumerate(snaps)])
    pc = tmp_path / "comp.npz"
    np.savez_compressed(pc, src=src, dst=dst, t=t, num_steps=np.int64(4))
    assert rdata._npz_memmaps(pc) is None
    got, _ = read_edgelist(pc, chunk_edges=7)
    _same_snaps(got, jrdata.read_edgelist(pc)[0])
    pe = tmp_path / "rows.npz"
    np.savez(pe, edges=np.stack([src, dst, t], axis=1))
    for chunk in (None, 5):
        _same_snaps(read_edgelist(pe, chunk_edges=chunk)[0],
                    jrdata.read_edgelist(pe, chunk_edges=chunk)[0])


# ------------------------------------------------------------- Engine -------

def _fit_pair(model, path, plan_kw, spec=None):
    """The port's and the JAX Engine's fits over one edge-list file, from
    the same seed-0 parameters (the JAX Engine's own) -> (port result, JAX
    result)."""
    smooth = {"tmgcn": "mproduct", "cdgcn": "none"}[model]
    jcfg = jm.DynGNNConfig(model=model, num_nodes=N, num_steps=T, window=W,
                           checkpoint_blocks=NB)
    cfg = tm.DynGNNConfig(model=model, num_nodes=N, num_steps=T, window=W,
                          checkpoint_blocks=NB)
    p0 = jm.init_params(jax.random.PRNGKey(0), jcfg)
    want = JEngine(JRunConfig(
        model=jcfg, data=JEdgeList(str(path), num_nodes=N,
                                   smoothing_mode=smooth, window=W),
        plan=JPlan(**plan_kw, sampling=spec and JSpec(**spec)),
        log_fn=_silent)).fit()
    got = Engine(RunConfig(
        model=cfg, data=EdgeListDTDG(str(path), num_nodes=N,
                                     smoothing_mode=smooth, window=W,
                                     chunk_edges=11),
        plan=ExecutionPlan(**plan_kw, sampling=spec and SamplingSpec(**spec)),
        log_fn=_silent),
        params=convert.params_from_jax(jax.tree.map(np.asarray, p0)),
        device="cpu").fit()
    return got, want


def _assert_params_close(got, want, tol):
    named = {jax.tree_util.keystr(k, simple=True, separator="."):
             np.asarray(v)
             for k, v in jax.tree_util.tree_flatten_with_path(
                 want.state.params)[0]}
    mine = convert.params_to_numpy(got.state.params)
    assert sorted(mine) == sorted(named)
    for k, v in named.items():
        np.testing.assert_allclose(mine[k], v, rtol=tol, atol=tol,
                                   err_msg=k)


def test_engine_eager_over_an_edge_list_matches_the_jax_engine(tmp_path):
    path = tmp_path / "trace.tsv"
    write_edgelist(path, _snaps(t=T, seed=4))
    got, want = _fit_pair("tmgcn", path, {"mode": "eager", "num_steps": 6})
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    assert len(got.losses) == 6
    _assert_params_close(got, want, 1e-6)


def test_engine_sampled_over_an_edge_list_matches_the_jax_engine(tmp_path):
    """``mode="sampled"`` on one shard: this process joins a one-rank gloo
    group (as the launcher does) for the port's fit."""
    path = tmp_path / "trace.npz"
    write_edgelist(path, _snaps(t=T, seed=6))
    spec = {"batch_nodes": 16, "fanouts": (4, 4), "seed": 2}
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        got, want = _fit_pair("cdgcn", path,
                              {"mode": "sampled", "shards": 1,
                               "num_epochs": 2}, spec=spec)
    finally:
        dist.destroy_process_group()
    assert len(got.losses) == 2 * NB
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    _assert_params_close(got, want, 1e-6)
    assert got.sample_report.rounds == want.sample_report.rounds
