"""Matrix generators (host CSR), a copy of the JAX package's gallery subset.

Pure numpy, kept here so the port imports nothing of the JAX package.  Every
generator returns host CSR arrays ``(indptr, indices, values, shape)``; the
arrays are bit-identical to the JAX package's for the same arguments.
Vectorised, so the 10⁵–10⁶-row sizes build in well under a second per
million rows.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["HostCsr", "anisotropic_2d", "poisson_2d", "poisson_3d", "spd_banded"]

#: (indptr, indices, values, shape) — the host-side CSR quadruple
HostCsr = Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]


def _coo_to_csr(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n: int
) -> HostCsr:
    """Sorted-duplicate-free COO triplets -> host CSR arrays."""
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(rows, minlength=n))
    return indptr, cols.astype(np.int32), vals.astype(np.float32), (n, n)


def poisson_2d(n_side: int) -> HostCsr:
    """5-point 2D Poisson stencil on an ``n_side`` × ``n_side`` grid (diag 4)."""
    n = n_side * n_side
    idx = np.arange(n)
    gi, gj = idx // n_side, idx % n_side
    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 4.0, np.float32)]
    for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        ni, nj = gi + di, gj + dj
        m = (ni >= 0) & (ni < n_side) & (nj >= 0) & (nj < n_side)
        rows.append(idx[m])
        cols.append((ni * n_side + nj)[m])
        vals.append(np.full(int(m.sum()), -1.0, np.float32))
    return _coo_to_csr(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n
    )


def poisson_3d(n_side: int) -> HostCsr:
    """7-point 3D Poisson stencil on an ``n_side``³ grid (diag 6)."""
    n = n_side ** 3
    idx = np.arange(n)
    gi = idx // (n_side * n_side)
    gj = (idx // n_side) % n_side
    gk = idx % n_side
    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 6.0, np.float32)]
    for di, dj, dk in (
        (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1)
    ):
        ni, nj, nk = gi + di, gj + dj, gk + dk
        m = (
            (ni >= 0) & (ni < n_side)
            & (nj >= 0) & (nj < n_side)
            & (nk >= 0) & (nk < n_side)
        )
        rows.append(idx[m])
        cols.append(((ni * n_side + nj) * n_side + nk)[m])
        vals.append(np.full(int(m.sum()), -1.0, np.float32))
    return _coo_to_csr(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n
    )


def anisotropic_2d(n_side: int, epsilon: float = 0.01) -> HostCsr:
    """Anisotropic diffusion ``-u_xx - ε u_yy`` on an ``n_side``² grid.

    With ``epsilon`` ≪ 1 the y-coupling is weak, which AMG's
    strength-of-connection filter must drop.
    """
    n = n_side * n_side
    eps = np.float32(epsilon)
    idx = np.arange(n)
    gi, gj = idx // n_side, idx % n_side
    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 2.0 * (1.0 + eps), np.float32)]
    # x-direction (strong): weight -1; y-direction (weak): weight -epsilon
    for (di, dj), w in (
        ((0, -1), -1.0), ((0, 1), -1.0), ((-1, 0), -eps), ((1, 0), -eps)
    ):
        ni, nj = gi + di, gj + dj
        m = (ni >= 0) & (ni < n_side) & (nj >= 0) & (nj < n_side)
        rows.append(idx[m])
        cols.append((ni * n_side + nj)[m])
        vals.append(np.full(int(m.sum()), w, np.float32))
    return _coo_to_csr(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n
    )


def spd_banded(
    n: int,
    offsets: Tuple[int, ...],
    shift: float,
    rng: np.random.Generator,
) -> HostCsr:
    """Diagonally dominant SPD banded matrix (the serve-traffic family)."""
    a = np.zeros((n, n), np.float32)
    idx = np.arange(n)
    a[idx, idx] = shift + rng.uniform(0.0, 0.5, size=n).astype(np.float32)
    for off in offsets:
        w = np.float32(-1.0 / off)
        a[idx[off:], idx[:-off]] = w
        a[idx[:-off], idx[off:]] = w
    # diagonal dominance keeps every draw SPD
    a[idx, idx] += np.abs(a).sum(axis=1).astype(np.float32)
    nz = a != 0
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(nz.sum(axis=1))
    indices = np.nonzero(nz)[1].astype(np.int32)
    values = a[nz].astype(np.float32)
    return indptr, indices, values, (n, n)
