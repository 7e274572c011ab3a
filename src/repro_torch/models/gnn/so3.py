"""SO(3) representation machinery for eSCN-style equivariant convolutions.

Port of ``repro.models.gnn.so3``.  The eSCN trick (arXiv:2302.03655, used
by EquiformerV2 arXiv:2306.12059): rotate each edge's features so the edge
direction aligns with the z-axis; in that frame the SH of the edge
direction is nonzero only at m=0, so the full Clebsch-Gordan tensor
product collapses to independent per-m linear maps (SO(2) convolutions).

Real Wigner-D matrices D^l(alpha, beta, gamma) for l <= L_MAX, per edge:

  * Wigner small-d via the explicit factorial sum (the coefficient tables
    are the reference's pure numpy, copied and cached; evaluation = powers
    of the cos / sin half-angle, the float64 coefficients cast to f32
    first, as the reference does),
  * complex D = e^{-i m' alpha} d^l_{m'm}(beta) e^{-i m gamma} (complex64),
  * real basis change D_real = U D U^dagger (standard real-SH unitary U).

Conventions: z-y-z Euler angles, active rotations; real SH ordering
m = -l..l within each l block; the full feature vector stacks blocks
l = 0..l_max (dim = (l_max+1)^2).  Positions are inputs, so no gradient
flows through the Wigner-D blocks.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

L_MAX_SUPPORTED = 8


def irreps_dim(l_max: int) -> int:
    return (l_max + 1) ** 2


def block_slices(l_max: int) -> list[slice]:
    out, off = [], 0
    for l in range(l_max + 1):
        out.append(slice(off, off + 2 * l + 1))
        off += 2 * l + 1
    return out


@lru_cache(maxsize=None)
def _wigner_d_tables(l: int):
    """Coefficient tables for d^l_{m'm}(beta) = sum_k c * cos^p * sin^q.

    Returns (rows, cols, cos_pow, sin_pow, coeff) flat numpy arrays.
    """
    rows, cols, cps, sps, cfs = [], [], [], [], []
    for mp in range(-l, l + 1):
        for m in range(-l, l + 1):
            pref = math.sqrt(math.factorial(l + mp) * math.factorial(l - mp)
                             * math.factorial(l + m) * math.factorial(l - m))
            k_lo = max(0, m - mp)
            k_hi = min(l + m, l - mp)
            for k in range(k_lo, k_hi + 1):
                denom = (math.factorial(l + m - k) * math.factorial(k)
                         * math.factorial(l - k - mp)
                         * math.factorial(k - m + mp))
                c = ((-1) ** (k - m + mp)) * pref / denom
                rows.append(mp + l)
                cols.append(m + l)
                cps.append(2 * l + m - mp - 2 * k)
                sps.append(2 * k + mp - m)
                cfs.append(c)
    return (np.asarray(rows, np.int32), np.asarray(cols, np.int32),
            np.asarray(cps, np.int32), np.asarray(sps, np.int32),
            np.asarray(cfs, np.float64))


@lru_cache(maxsize=None)
def _real_u_matrix(l: int) -> np.ndarray:
    """Unitary U with Y_real = U Y_complex (complex m ordered -l..l)."""
    dim = 2 * l + 1
    u = np.zeros((dim, dim), dtype=np.complex128)
    s2 = 1.0 / math.sqrt(2.0)
    for m in range(-l, l + 1):
        i = m + l
        if m < 0:
            # sign fixed so that the l=1 block in (y, z, x) ordering equals
            # the coordinate rotation matrix (validated in tests)
            u[i, m + l] = -1j * s2
            u[i, -m + l] = 1j * s2 * ((-1) ** m)
        elif m == 0:
            u[i, l] = 1.0
        else:
            u[i, -m + l] = s2
            u[i, m + l] = s2 * ((-1) ** m)
    return u


def wigner_d_real(l: int, alpha: torch.Tensor, beta: torch.Tensor,
                  gamma: torch.Tensor) -> torch.Tensor:
    """Real Wigner-D matrices for one l; angles (...,) -> (..., 2l+1, 2l+1)."""
    rows, cols, cps, sps, cfs = _wigner_d_tables(l)
    dev = beta.device
    c = torch.cos(beta / 2.0)
    s = torch.sin(beta / 2.0)
    # powers 0..2l gathered from a table of stacked powers
    pows_c = torch.stack([c ** p for p in range(2 * l + 1)], dim=-1)
    pows_s = torch.stack([s ** p for p in range(2 * l + 1)], dim=-1)
    terms = (torch.as_tensor(cfs.astype(np.float32), device=dev)
             * pows_c[..., torch.as_tensor(cps, device=dev).long()]
             * pows_s[..., torch.as_tensor(sps, device=dev).long()])
    dim = 2 * l + 1
    flat = torch.as_tensor(rows.astype(np.int64) * dim + cols, device=dev)
    small_d = terms.new_zeros(beta.shape + (dim * dim,)).index_add(
        -1, flat, terms).reshape(beta.shape + (dim, dim))
    m_range = torch.arange(-l, l + 1, dtype=torch.float32, device=dev)
    e_alpha = torch.exp(-1j * (m_range * alpha[..., None]))  # (..., dim)
    e_gamma = torch.exp(-1j * (m_range * gamma[..., None]))
    d_complex = (e_alpha[..., :, None] * small_d.to(torch.complex64)
                 * e_gamma[..., None, :])
    u = torch.as_tensor(_real_u_matrix(l), dtype=torch.complex64,
                        device=dev)
    d_real = torch.einsum("ij,...jk,lk->...il", u, d_complex, u.conj())
    return d_real.real.to(torch.float32)


def wigner_d_real_stack(l_max: int, alpha: torch.Tensor, beta: torch.Tensor,
                        gamma: torch.Tensor) -> list[torch.Tensor]:
    """Per-l list of real Wigner-D matrices (block-diagonal factors)."""
    return [wigner_d_real(l, alpha, beta, gamma) for l in range(l_max + 1)]


def edge_rotation_angles(vec: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Euler angles (alpha=0, beta, gamma) rotating edge direction -> z-axis.

    For unit r with polar angle theta and azimuth phi, R = Ry(-theta) Rz(-phi)
    maps r to z; as z-y-z Euler (Rz(a) Ry(b) Rz(g)): a = 0, b = -theta,
    g = -phi.
    """
    r = vec / torch.clamp(torch.linalg.norm(vec, dim=-1, keepdim=True),
                          min=1e-9)
    theta = torch.arccos(torch.clamp(r[..., 2], -1.0, 1.0))
    phi = torch.atan2(r[..., 1], r[..., 0])
    return torch.zeros_like(theta), -theta, -phi


def rotate_features(feats: torch.Tensor, d_blocks: list[torch.Tensor],
                    l_max: int, inverse: bool = False) -> torch.Tensor:
    """Apply block-diagonal Wigner-D to stacked irreps features.

    feats: (E, dim, C); d_blocks[l]: (E, 2l+1, 2l+1).
    """
    out = []
    for l, sl in enumerate(block_slices(l_max)):
        d = d_blocks[l]
        if inverse:
            d = d.transpose(-1, -2)   # orthogonal: inverse = transpose
        out.append(torch.bmm(d, feats[:, sl, :]))
    return torch.cat(out, dim=1)
