"""The traffic generator: a cell's snapshots, features, labels and initial
parameters, made on the device from ``--seed``.

Snapshot t's raw (src, dst) lanes come from a generator seeded by (seed,
t) alone (:func:`snapshot_seed`), so a rank makes only its own snapshots
and the reference remakes any snapshot by itself.  The recipe follows the
port's host pipeline (``data/dyngnn.dataset_from_snapshots`` and
``core/dtdg.build_batch``), rewritten on the device:

* ``edges_per_snapshot`` lanes with src and dst uniform in [0, N);
* N self-loops after them (the ``A + I`` of Eq. 1) and zero lanes up to a
  multiple of ``lane_multiple``, whose mask is 0;
* features (in-degree, out-degree) of the raw lanes, F = 2;
* labels: 1 where the in-degree lies above the snapshot's median (the
  mean of the two middle values for even N, as ``np.median`` takes it).

Edge values are 1 (no M-transform smoothing: the traffic's counts stand
for post-smoothing snapshots).  Nothing here imports the program.
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def snapshot_seed(seed: int, t: int) -> int:
    """The generator seed of snapshot ``t`` under run seed ``seed`` (any
    whole number; folded to 64 bits) -> [0, 2**63)."""
    return _splitmix64(_splitmix64(seed & _MASK64) ^ (t + 1)) >> 1


def param_seed(seed: int) -> int:
    """The generator seed of the initial parameters."""
    return _splitmix64(_splitmix64(seed & _MASK64) ^ _MASK64) >> 1


def lanes(traffic: dict) -> int:
    """Padded lanes a snapshot: raw lanes + N self-loops, rounded up."""
    m = traffic["lane_multiple"]
    real = traffic["edges_per_snapshot"] + traffic["nodes"]
    return (real + m - 1) // m * m


def raw_edges(seed: int, t: int, traffic: dict, device) -> torch.Tensor:
    """Snapshot t's raw lanes: (2, edges_per_snapshot) int32, rows (src,
    dst), uniform over the N vertices."""
    if traffic["generator"] != "uniform":
        raise ValueError(f"unknown generator {traffic['generator']!r}")
    g = torch.Generator(device=device)
    g.manual_seed(snapshot_seed(seed, t))
    return torch.randint(0, traffic["nodes"],
                         (2, traffic["edges_per_snapshot"]), generator=g,
                         dtype=torch.int32, device=device)


def degrees(raw: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(in-degree, out-degree) of raw lanes, float32 (exact: integer counts
    below 2**24)."""
    ones = torch.ones(raw.shape[1], dtype=torch.float32, device=raw.device)
    ind = torch.zeros(n, dtype=torch.float32, device=raw.device)
    outd = torch.zeros(n, dtype=torch.float32, device=raw.device)
    return ind.index_add_(0, raw[1], ones), outd.index_add_(0, raw[0], ones)


def features_and_labels(raw: torch.Tensor, n: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> frame (N, 2) float32 [in-degree, out-degree] and labels (N,)
    int32: in-degree above the median."""
    ind, outd = degrees(raw, n)
    srt = torch.sort(ind).values
    med = srt[n // 2] if n % 2 else (srt[n // 2 - 1] + srt[n // 2]) / 2
    return (torch.stack([ind, outd], dim=1),
            (ind > med).to(torch.int32))


def padded_lanes(raw: torch.Tensor, traffic: dict
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> edges (E_pad, 2) int32 [raw; self-loops; zeros] and mask (E_pad,)
    float32 (1 on the raw lanes and the self-loops)."""
    n, e = traffic["nodes"], traffic["edges_per_snapshot"]
    e_pad = lanes(traffic)
    edges = torch.zeros((e_pad, 2), dtype=torch.int32, device=raw.device)
    edges[:e] = raw.T
    edges[e:e + n] = torch.arange(n, dtype=torch.int32,
                                  device=raw.device)[:, None]
    mask = torch.zeros(e_pad, dtype=torch.float32, device=raw.device)
    mask[:e + n] = 1.0
    return edges, mask


def make_params(seed: int, shapes: list[tuple[str, tuple, float]],
                device) -> dict[str, torch.Tensor]:
    """Initial parameters {name: tensor}: ``shapes`` lists (name, shape,
    scale) in the model's order; a leaf is uniform in [-scale, scale), or
    zeros where scale is 0.  One draw on the device for all leaves."""
    total = sum(torch.Size(s).numel() for _, s, _ in shapes)
    g = torch.Generator(device=device)
    g.manual_seed(param_seed(seed))
    flat = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, scale in shapes:
        k = torch.Size(shape).numel()
        out[name] = ((flat[at:at + k] * 2 - 1) * scale).reshape(shape) \
            if scale else torch.zeros(shape, device=device)
        at += k
    return out
