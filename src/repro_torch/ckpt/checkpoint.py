"""Checkpoint save / restore (port of ``repro.ckpt.checkpoint``).

The reference's layout, so that either package reads the other's
checkpoints:

* a checkpoint is a directory ``step_<n>/`` holding one ``leaves.npz``
  (``leaf_<i>``, host arrays) and a ``manifest.json`` (the leaves'
  paths, the step and the caller's ``extra``);
* leaves are flattened in the order ``jax.tree.leaves`` gives the same
  structure — dict keys sorted, list and tuple items in order — and
  named by their path joined with ``/``.  A ``ParamTree`` is the nested
  dict its ``state_dict`` names spell (``layers.0.gcn.w`` ->
  ``layers/0/gcn/w``), as is a dict keyed by such names (the AdamW
  moments), so the port's ``(params, opt_state)`` has the JAX eager
  trainer's paths and order;
* ``save`` copies the leaves to the host before it returns — for CUDA
  tensors one asynchronous copy per leaf into a pinned host buffer, then
  one synchronize; CPU tensors are cloned, so a later in-place update
  cannot race the writer — and a daemon thread writes ``step_<n>.tmp``
  and renames it into place (a preemption mid-write never corrupts the
  newest complete checkpoint).  One save is in flight at a time; the
  newest ``keep`` are kept;
* ``restore(step, like, device=)`` fills the structure of ``like`` (a
  ``ParamTree``, the AdamW state dict, the list of per-layer carries, or
  a tuple / dict of them) with the saved leaves, matched by path, as
  tensors of ``like``'s dtypes on ``device`` (default: each ``like``
  leaf's own).  A different leaf count or an unknown path raises
  ``ValueError`` ("incompatible").  Checkpoints hold whole host arrays,
  so the width the run restores onto may differ from the one it saved
  at (``repro_torch.elastic`` slices the carries).
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn


def _parts(name: str) -> tuple:
    """A dotted ``state_dict`` name -> its path parts, list indices as
    ints (so they sort as JAX orders list items)."""
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def _items(tree: Any) -> list | None:
    """The children of a tree node as ``(path parts, child)`` in JAX's
    flattening order, or None for a leaf."""
    if isinstance(tree, nn.Module):
        return sorted(((_parts(k), v) for k, v in tree.named_parameters()),
                      key=lambda kv: kv[0])
    if isinstance(tree, dict):
        return sorted(((_parts(str(k)), v) for k, v in tree.items()),
                      key=lambda kv: kv[0])
    if isinstance(tree, (list, tuple)):
        return [((i,), v) for i, v in enumerate(tree)]
    return None


def flatten_with_paths(tree: Any) -> tuple[list[str], list]:
    """``tree`` -> (paths, leaves) in JAX's order and naming."""
    paths: list[str] = []
    leaves: list = []

    def walk(node, prefix: tuple) -> None:
        kids = _items(node)
        if kids is None:
            paths.append("/".join(str(p) for p in prefix))
            leaves.append(node)
            return
        for parts, child in kids:
            walk(child, prefix + parts)

    walk(tree, ())
    return paths, leaves


def _fill(like: Any, prefix: tuple, get) -> Any:
    """A copy of ``like``'s structure whose leaves are ``get(path,
    like_leaf)``."""
    if isinstance(like, nn.Module):
        out = copy.deepcopy(like)
        with torch.no_grad():
            for name, p in out.named_parameters():
                path = prefix + _parts(name)
                p.data = get("/".join(str(x) for x in path), p)
        return out
    if isinstance(like, dict):
        return {k: _fill(v, prefix + _parts(str(k)), get)
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_fill(v, prefix + (i,), get)
                          for i, v in enumerate(like))
    return get("/".join(str(x) for x in prefix), like)


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- save ----
    @staticmethod
    def _host_copies(leaves: list) -> list[np.ndarray]:
        """Each leaf as a host numpy array the caller cannot change any
        more: CUDA leaves through one pinned buffer each and one
        synchronize (torch's host allocator keeps the pinned blocks for
        the next save)."""
        host, cuda = [], None
        for x in leaves:
            t = x.detach() if isinstance(x, torch.Tensor) \
                else torch.as_tensor(np.asarray(x))
            if t.is_cuda:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                host.append(buf)
                cuda = t.device
            else:
                host.append(t.clone())
        if cuda is not None:
            torch.cuda.synchronize(cuda)
        return [h.numpy() for h in host]

    def save(self, step: int, tree: Any, extra: dict | None = None,
             blocking: bool = False) -> None:
        self.wait()   # one in-flight save at a time
        paths, leaves = flatten_with_paths(tree)
        host_leaves = self._host_copies(leaves)
        manifest = {"step": int(step), "paths": paths,
                    "extra": extra or {}}

        def write():
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "leaves.npz",
                     **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ---------------------------------------------------------- restore ----
    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob(
            "step_*") if p.is_dir() and not p.name.endswith(".tmp"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any,
                device: str | torch.device | None = None
                ) -> tuple[Any, dict]:
        """Restore into the structure of ``like`` -> (tree, extra); each
        leaf on ``device``, or on its ``like`` leaf's device when None
        (the AdamW step counter stays on the host)."""
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / "leaves.npz") as data:
            saved = {p: data[f"leaf_{i}"]
                     for i, p in enumerate(manifest["paths"])}
        like_paths, _ = flatten_with_paths(like)
        if len(like_paths) != len(saved):
            raise ValueError(
                f"checkpoint has {len(saved)} leaves, target structure has "
                f"{len(like_paths)} — incompatible config")
        missing = [p for p in like_paths if p not in saved]
        if missing:
            raise ValueError(f"checkpoint has no leaf {missing[0]!r} of "
                             "the target structure — incompatible config")

        def get(path: str, leaf):
            arr = torch.from_numpy(saved[path])
            if not isinstance(leaf, torch.Tensor):
                return arr if device is None else arr.to(device)
            return arr.to(device=leaf.device if device is None else device,
                          dtype=leaf.dtype)

        return _fill(like, (), get), manifest["extra"]
