"""The comparison that decides ``correct``: the port's first three train
steps against the plain reference's, from the same inputs and initial
parameters.

Three numbers, each against its limit in ``limits/<workload>.json``:

* ``loss``: the largest relative gap of the three steps' losses;
* ``grad1``: the first gradient as AdamW took it (``m_1 / (1 - b1)``,
  clipped), by the worst leaf: ``| |g_prog| - |g_ref| |`` over the larger
  of the reference leaf's norm and the median leaf's;
* ``delta3``: the parameters' change after the three steps, by the worst
  leaf in the same way, over the leaves whose reference gradient is at
  least a thousandth of the median leaf's (a leaf under that moves under
  Adam by round-off alone).
"""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path

import torch

NUMBERS = ("loss", "grad1", "delta3")
#: a leaf whose first reference gradient is under this share of the
#: median leaf's is left out of ``delta3``
QUIET_LEAF = 1e-3


def _norms(tree: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def worst_leaf(got: dict, want: dict, names: list[str]) -> float:
    a, b = _norms(got), _norms(want)
    med = statistics.median(b[k] for k in names)
    return max(abs(a[k] - b[k]) / max(b[k], med, 1e-30) for k in names)


def moving_leaves(ref_grad1: dict) -> list[str]:
    g = _norms(ref_grad1)
    med = statistics.median(g.values())
    return [k for k, v in g.items() if v >= QUIET_LEAF * med]


def numbers(prog: dict, ref: dict) -> dict[str, float]:
    """``prog`` and ``ref``: {"losses", "grad1", "delta"} -> the three
    numbers (inf where the program's are not finite)."""
    if not all(math.isfinite(x) for x in prog["losses"]):
        return {k: math.inf for k in NUMBERS}
    loss = max(abs(a - b) / abs(b) for a, b in
               zip(prog["losses"], ref["losses"], strict=True))
    names = sorted(ref["grad1"])
    return {"loss": loss,
            "grad1": worst_leaf(prog["grad1"], ref["grad1"], names),
            "delta3": worst_leaf(prog["delta"], ref["delta"],
                                 moving_leaves(ref["grad1"]))}


def load_limits(root: Path, workload: str) -> dict[str, float] | None:
    path = root / "perfbench" / "limits" / f"{workload}.json"
    if not path.is_file():
        return None
    return json.loads(path.read_text())["limits"]


def verdict(nums: dict[str, float], limits: dict | None
            ) -> tuple[bool, dict]:
    """-> (correct, {number: {"value", "limit"}}); with no limits the
    run is not correct."""
    checks = {k: {"value": v, "limit": None if limits is None
                  else limits.get(k)} for k, v in nums.items()}
    if limits is None:
        return False, checks
    ok = all(math.isfinite(c["value"]) and
             (c["limit"] is None or c["value"] <= c["limit"])
             for c in checks.values())
    return ok, checks
