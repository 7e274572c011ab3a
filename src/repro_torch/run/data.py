"""Data sources: the *what* of a training run (port of ``repro.run.data``).

A :class:`DataSource` yields a ``DTDGDataset``; the Engine asks it to build
and owns nothing else:

* :class:`SyntheticTrace` — the evolving synthetic DTDG generator as a
  declarative spec;
* :class:`EdgeListDTDG` — timestamped edge-list files (``.tsv`` /
  ``.npz``, the form the paper's epinions / flickr / youtube traces ship
  in) loaded into a ``DTDGDataset``, in memory or out of core
  (``chunk_edges``);
* :class:`InMemoryDTDG` — an already-built dataset.

``write_edgelist`` is the matching writer.  The file I/O is host numpy,
copied from the reference and held byte-identical to it by
``tests/test_torch_edgelist.py``.
"""

from __future__ import annotations

import re
import zipfile
from dataclasses import dataclass
from pathlib import Path
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.data.dyngnn import (DTDGDataset, DTDGPipeline,
                                     dataset_from_snapshots,
                                     synthetic_dataset)


@runtime_checkable
class DataSource(Protocol):
    """Anything that can build a ``DTDGDataset`` on demand.

    ``num_nodes`` is the source's nominal vertex count (None when only
    known after reading, e.g. an edge-list file); ``build(num_nodes=n)``
    must honor an override >= the nominal count (vertex-axis padding).
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


@dataclass(frozen=True)
class EdgeListDTDG:
    """Timestamped edge-list loader: ``(src, dst, t)`` rows -> DTDG.

    Formats (selected by extension):

    * ``.npz`` — arrays ``src``, ``dst``, ``t`` (or one ``edges`` array
      of shape (E, 3));
    * anything else — whitespace/tab-separated text, one ``src dst t``
      row per edge, ``#`` comments allowed.

    Snapshot ``k`` holds the file-order edges with ``t == t_min + k``
    (timestamps are treated as consecutive integer bins; empty bins make
    empty snapshots).  Smoothing / features / labels are derived exactly
    as for the synthetic traces (``dataset_from_snapshots``), so a
    written-then-loaded trace trains bit-identically to its in-memory
    original.

    ``chunk_edges`` switches the read out-of-core: text files stream
    line-by-line in ``chunk_edges``-row chunks and ``.npz`` members are
    memory-mapped straight out of the archive (``_npz_memmaps``) — the
    monolithic ``(E, 3)`` int64 row table is never materialized, only
    the per-snapshot int32 edge lists.  The binned result is identical
    to the in-memory read (round-trip tested).
    """

    path: str
    num_nodes: int | None = None
    smoothing_mode: str = "none"
    window: int = 5
    edge_life: int = 5
    chunk_edges: int | None = None  # out-of-core read: rows per chunk

    def build(self, num_nodes: int | None = None) -> DTDGDataset:
        snaps, n_seen = read_edgelist(self.path,
                                      chunk_edges=self.chunk_edges)
        nominal = self.num_nodes or n_seen
        if nominal < n_seen:
            raise ValueError(f"num_nodes={nominal} but {self.path} "
                             f"references node ids up to {n_seen - 1}")
        # labels/features derive from the NOMINAL node count; a padding
        # override appends isolated vertices afterwards so pad nodes can
        # never shift the label median of the real ones
        ds = dataset_from_snapshots(
            snaps, nominal, smoothing_mode=self.smoothing_mode,
            window=self.window, edge_life=self.edge_life)
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


# ------------------------------------------------ edge-list file I/O -------

def _tsv_num_steps(path: Path) -> int | None:
    """``num_steps=K`` from the header comment, if the file carries one."""
    with open(path) as f:
        first = f.readline()
    if first.startswith("#"):
        m = re.search(r"num_steps=(\d+)", first)
        if m:
            return int(m.group(1))
    return None


def read_edgelist(path: str | Path,
                  chunk_edges: int | None = None
                  ) -> tuple[list[np.ndarray], int]:
    """(snapshots, min num_nodes) from a timestamped edge-list file.

    Files written by ``write_edgelist`` carry a ``num_steps`` marker
    (npz key / tsv header comment) so that empty snapshots — including
    leading/trailing ones — round-trip exactly.  External files without
    the marker are binned over ``[t.min(), t.max()]``: empty bins inside
    that span become empty snapshots, but empty bins outside it are
    unknowable and dropped.

    ``chunk_edges`` enables the out-of-core read path (chunked text
    scan / zip-member memmap) — same snapshots, bounded peak memory.
    """
    path = Path(path)
    if chunk_edges is not None:
        return _read_edgelist_chunked(path, chunk_edges)
    num_steps = None
    if path.suffix == ".npz":
        with np.load(path) as z:
            if "edges" in z:
                rows = np.asarray(z["edges"], dtype=np.int64)
                src, dst, t = rows[:, 0], rows[:, 1], rows[:, 2]
            else:
                src = np.asarray(z["src"], dtype=np.int64)
                dst = np.asarray(z["dst"], dtype=np.int64)
                t = np.asarray(z["t"], dtype=np.int64)
            if "num_steps" in z:
                num_steps = int(z["num_steps"])
    else:
        rows = np.loadtxt(path, dtype=np.int64, comments="#", ndmin=2)
        if rows.shape[1] != 3:
            raise ValueError(f"{path}: expected 'src dst t' rows, got "
                             f"{rows.shape[1]} columns")
        src, dst, t = rows[:, 0], rows[:, 1], rows[:, 2]
        num_steps = _tsv_num_steps(path)
    if src.shape[0] == 0:
        raise ValueError(f"{path}: empty edge list")
    if src.min() < 0 or dst.min() < 0:
        raise ValueError(f"{path}: negative node ids")
    edges = np.stack([src, dst], axis=1).astype(np.int32)
    if num_steps is not None:
        if t.min() < 0 or t.max() >= num_steps:
            raise ValueError(f"{path}: timestamps outside the declared "
                             f"num_steps={num_steps}")
        bins = range(0, num_steps)
    else:
        bins = range(int(t.min()), int(t.max()) + 1)
    snaps = [edges[t == v] for v in bins]
    return snaps, int(max(src.max(), dst.max())) + 1


def write_edgelist(path: str | Path,
                   snapshots: list[np.ndarray]) -> None:
    """Write snapshots as a timestamped edge list (exact inverse of
    ``read_edgelist`` up to the edge dtype: a ``num_steps`` marker keeps
    empty snapshots, snapshot k is stamped ``t=k`` in row order)."""
    path = Path(path)
    num_steps = len(snapshots)
    src = np.concatenate([np.asarray(s[:, 0], dtype=np.int64)
                          for s in snapshots])
    dst = np.concatenate([np.asarray(s[:, 1], dtype=np.int64)
                          for s in snapshots])
    t = np.concatenate([np.full((s.shape[0],), i, dtype=np.int64)
                        for i, s in enumerate(snapshots)])
    if path.suffix == ".npz":
        np.savez(path, src=src, dst=dst, t=t,
                 num_steps=np.int64(num_steps))
        return
    rows = np.stack([src, dst, t], axis=1)
    np.savetxt(path, rows, fmt="%d", delimiter="\t",
               header=f"src\tdst\tt\tnum_steps={num_steps}")


# --------------------------------------------- out-of-core read path -------

def _npz_memmaps(path: Path) -> dict[str, np.ndarray] | None:
    """Zero-copy ``np.memmap`` views of an UNCOMPRESSED npz's members.

    ``np.load(..., mmap_mode="r")`` silently ignores the mmap request
    for ``.npz`` archives (it only ever mmaps bare ``.npy`` files), so
    this locates each stored member's ``.npy`` payload inside the zip —
    local file header at ``ZipInfo.header_offset``, then the npy header
    — and maps the data region of the ARCHIVE file directly.  Returns
    None when any member is deflated (no contiguous bytes to map; the
    caller falls back to a regular load).
    """
    out: dict[str, np.ndarray] = {}
    with zipfile.ZipFile(path) as z, open(path, "rb") as raw:
        for zi in z.infolist():
            if zi.compress_type != zipfile.ZIP_STORED:
                return None
            # local header: 30 fixed bytes + name + extra (the extra
            # field can differ from the central directory's, so read it)
            raw.seek(zi.header_offset)
            hdr = raw.read(30)
            if hdr[:4] != b"PK\x03\x04":
                return None
            name_len = int.from_bytes(hdr[26:28], "little")
            extra_len = int.from_bytes(hdr[28:30], "little")
            raw.seek(zi.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(raw)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(
                    raw)
            elif version == (2, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(
                    raw)
            else:
                return None
            name = zi.filename
            if name.endswith(".npy"):
                name = name[:-4]
            out[name] = np.memmap(path, dtype=dtype, mode="r",
                                  offset=raw.tell(), shape=shape,
                                  order="F" if fortran else "C")
    return out


def _iter_tsv_chunks(path: Path, chunk_edges: int):
    """Yield ``(<=chunk_edges, 3)`` int64 row blocks from a text edge
    list without ever holding the whole table."""
    buf: list[tuple[int, int, int]] = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            parts = s.split()
            if len(parts) != 3:
                raise ValueError(f"{path}: expected 'src dst t' rows, "
                                 f"got {len(parts)} columns")
            buf.append((int(parts[0]), int(parts[1]), int(parts[2])))
            if len(buf) >= chunk_edges:
                yield np.asarray(buf, dtype=np.int64)
                buf = []
    if buf:
        yield np.asarray(buf, dtype=np.int64)


def _iter_array_chunks(src, dst, t, chunk_edges: int):
    """Yield row blocks from (possibly memory-mapped) column arrays —
    each chunk is the only region pulled into memory."""
    n = src.shape[0]
    for lo in range(0, n, chunk_edges):
        hi = min(lo + chunk_edges, n)
        yield np.stack([np.asarray(src[lo:hi], dtype=np.int64),
                        np.asarray(dst[lo:hi], dtype=np.int64),
                        np.asarray(t[lo:hi], dtype=np.int64)], axis=1)


def _read_edgelist_chunked(path: Path, chunk_edges: int
                           ) -> tuple[list[np.ndarray], int]:
    """Out-of-core ``read_edgelist``: same snapshots, bounded memory."""
    if chunk_edges < 1:
        raise ValueError(f"chunk_edges must be >= 1, got {chunk_edges}")
    num_steps = None
    if path.suffix == ".npz":
        arrs = _npz_memmaps(path)
        if arrs is None:    # deflated archive: no mappable bytes
            with np.load(path) as z:
                arrs = {k: z[k] for k in z.files}
        if "edges" in arrs:
            rows = arrs["edges"]
            src, dst, t = rows[:, 0], rows[:, 1], rows[:, 2]
        else:
            src, dst, t = arrs["src"], arrs["dst"], arrs["t"]
        if "num_steps" in arrs:
            num_steps = int(np.asarray(arrs["num_steps"]))
        chunks = _iter_array_chunks(src, dst, t, chunk_edges)
    else:
        num_steps = _tsv_num_steps(path)
        chunks = _iter_tsv_chunks(path, chunk_edges)

    # bin incrementally: per chunk, file-order edge runs per timestamp;
    # concatenating runs in chunk order preserves file order per bin
    parts: dict[int, list[np.ndarray]] = {}
    total, n_seen = 0, 0
    t_lo = t_hi = None
    for rows in chunks:
        if rows.shape[0] == 0:
            continue
        s, d, tt = rows[:, 0], rows[:, 1], rows[:, 2]
        if s.min() < 0 or d.min() < 0:
            raise ValueError(f"{path}: negative node ids")
        total += rows.shape[0]
        n_seen = max(n_seen, int(s.max()) + 1, int(d.max()) + 1)
        lo, hi = int(tt.min()), int(tt.max())
        t_lo = lo if t_lo is None else min(t_lo, lo)
        t_hi = hi if t_hi is None else max(t_hi, hi)
        edges = np.stack([s, d], axis=1).astype(np.int32)
        for v in np.unique(tt):
            parts.setdefault(int(v), []).append(edges[tt == v])
    if total == 0:
        raise ValueError(f"{path}: empty edge list")
    if num_steps is not None:
        if t_lo < 0 or t_hi >= num_steps:
            raise ValueError(f"{path}: timestamps outside the declared "
                             f"num_steps={num_steps}")
        bins = range(0, num_steps)
    else:
        bins = range(t_lo, t_hi + 1)
    empty = np.zeros((0, 2), dtype=np.int32)
    snaps = [np.concatenate(parts[v], axis=0) if v in parts else empty
             for v in bins]
    return snaps, n_seen
