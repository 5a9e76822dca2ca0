"""ParILU (Chow–Patel) incomplete factorisation + iterative triangular solves.

Instead of the sequential IKJ factorisation, ParILU iterates fixed-point
sweeps over the nonzeros

    l_ij = (a_ij - sum_{k<j} l_ik u_kj) / u_jj     (i > j)
    u_ij =  a_ij - sum_{k<i} l_ik u_kj             (i <= j)

updating every entry at once, and applies M⁻¹ = (LU)⁻¹ by a fixed number of
Jacobi sweeps per triangle (Ginkgo does the same on GPUs).  As in the JAX
package:

* setup (host, numpy): the sparsity analysis of S(L), S(U) and the padded
  dependency tables — here vectorised over the entries, with tables equal to
  the JAX package's (its per-entry Python loops would take minutes at 10⁶
  rows);
* sweeps (device): gathers and a row sum of the (nnz, K) products; the
  slots number L's (U's) entries in CSR order, so a sweep's new factors
  are gathers of the entries' values (no scatter at all);
* apply (device): Jacobi triangular sweeps whose ``y[rows] += l x[cols]``
  is a fixed-order segment sum over the row-sorted entries
  (:func:`repro_torch.sparse.ops.segment_spmv`), not ``index_add_``, whose
  atomics would not repeat bit for bit on the card.

No Pallas kernel serves any of this in the JAX package, so none is owed.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.linop import LinOp
from repro_torch.sparse.formats import Csr, host_array
from repro_torch.sparse.ops import segment_spmv

__all__ = [
    "ParILU",
    "ParILUStructure",
    "batch_parilu_apply",
    "parilu_setup",
    "parilu_factorize",
    "parilu_preconditioner",
]


@dataclasses.dataclass(frozen=True, eq=False)
class ParILUStructure:
    """Host-precomputed sparsity structure (static shapes for the sweeps)."""

    # L strict-lower entries (unit diagonal implied)
    l_rows: np.ndarray
    l_cols: np.ndarray
    # U upper (incl. diagonal) entries
    u_rows: np.ndarray
    u_cols: np.ndarray
    # per-A-nonzero metadata
    a_rows: np.ndarray
    a_cols: np.ndarray
    is_lower: np.ndarray  # (nnz,) bool: strictly lower -> L slot else U slot
    slot: np.ndarray  # (nnz,) index into l_vals or u_vals
    # fixed-width dependency tables: for A-nonzero t, the k-intersection
    # contributions l_ik * u_kj; width-padded with sentinel 0-entries
    dep_l: np.ndarray  # (nnz, K) indices into l_vals (+1 shifted; 0 = zero pad)
    dep_u: np.ndarray  # (nnz, K) indices into u_vals (+1 shifted; 0 = zero pad)
    u_diag_slot: np.ndarray  # (n,) slot of u_jj in u_vals
    n: int


def parilu_setup(A: Csr) -> ParILUStructure:
    """The structure of A's (duplicate-free) CSR pattern split into L and U.

    Entry t = (i, j) depends on the pairs (l_ik, u_kj) for the entries k of
    row i, in row order, with k < min(i, j) and (k, j) in the pattern.  The
    candidates are every pair of entries of one row (Σ row length² in all),
    matched against the pattern by a sorted-key search.
    """
    if not isinstance(A, Csr):
        raise TypeError(f"ParILU needs a CSR operand, got {type(A).__name__}")
    indptr = host_array(A.indptr).astype(np.int64)
    cols = host_array(A.indices).astype(np.int64)
    n = int(A.shape[0])
    row_len = np.diff(indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), row_len)
    nnz = rows.size

    is_lower = rows > cols
    # slot: an entry's rank among the L (or U) entries in CSR order
    l_rank = np.cumsum(is_lower) - 1
    u_rank = np.cumsum(~is_lower) - 1
    slot = np.where(is_lower, l_rank, u_rank)

    diag = np.flatnonzero(rows == cols)
    has_diag = np.zeros(n, bool)
    has_diag[rows[diag]] = True
    if not has_diag.all():
        j = int(np.flatnonzero(~has_diag)[0])
        raise KeyError((j, j))
    u_diag_slot = np.zeros(n, np.int64)
    u_diag_slot[rows[diag]] = u_rank[diag]

    # candidate pairs (t, e): every entry e of entry t's row, in row order
    t_len = row_len[rows]
    t_of = np.repeat(np.arange(nnz, dtype=np.int64), t_len)
    first = np.cumsum(t_len) - t_len
    e_of = indptr[rows][t_of] + np.arange(t_of.size, dtype=np.int64) - first[t_of]
    k_of = cols[e_of]
    j_of = cols[t_of]
    keep = k_of < np.minimum(rows[t_of], j_of)
    t_of, e_of, k_of, j_of = t_of[keep], e_of[keep], k_of[keep], j_of[keep]
    # is (k, j) an entry of A?  keys k n + j, searched in sorted order
    keys = rows * n + cols
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    want = k_of * n + j_of
    pos = np.searchsorted(sorted_keys, want)
    found = pos < nnz
    found[found] = sorted_keys[pos[found]] == want[found]
    t_of, e_of = t_of[found], e_of[found]
    kj = order[pos[found]]

    counts = np.bincount(t_of, minlength=nnz)
    K = max(int(counts.max()) if nnz else 0, 1)
    q = np.arange(t_of.size, dtype=np.int64) - (np.cumsum(counts) - counts)[t_of]
    dep_l = np.zeros((nnz, K), np.int32)  # 0 = padding (points at zero slot)
    dep_u = np.zeros((nnz, K), np.int32)
    dep_l[t_of, q] = l_rank[e_of] + 1  # shift: 0 reserved for padding
    dep_u[t_of, q] = u_rank[kj] + 1

    return ParILUStructure(
        l_rows=rows[is_lower].astype(np.int32),
        l_cols=cols[is_lower].astype(np.int32),
        u_rows=rows[~is_lower].astype(np.int32),
        u_cols=cols[~is_lower].astype(np.int32),
        a_rows=rows.astype(np.int32),
        a_cols=cols.astype(np.int32),
        is_lower=is_lower,
        slot=slot.astype(np.int32),
        dep_l=dep_l,
        dep_u=dep_u,
        u_diag_slot=u_diag_slot.astype(np.int32),
        n=n,
    )


def _on(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def parilu_factorize(
    A: Csr, structure: ParILUStructure = None, sweeps: int = 5
) -> Tuple[torch.Tensor, torch.Tensor, ParILUStructure]:
    """Run the fixed-point sweeps; returns (l_vals, u_vals, structure)."""
    st = structure or parilu_setup(A)
    a_vals = A.values  # CSR order == (a_rows, a_cols) construction order
    dtype, dev = a_vals.dtype, a_vals.device

    # slots number the L (U) entries in CSR order, so slot t of L is the
    # t-th lower entry: a sweep writes every slot once, by a gather
    lower = _on(np.flatnonzero(st.is_lower), dev)
    upper = _on(np.flatnonzero(~st.is_lower), dev)
    dep_l = _on(st.dep_l.astype(np.int64), dev)
    dep_u = _on(st.dep_u.astype(np.int64), dev)
    # u_jj's slot for every lower entry (column j)
    jj = _on(st.u_diag_slot[st.a_cols[st.is_lower]].astype(np.int64), dev)

    zero = torch.zeros(1, dtype=dtype, device=dev)
    # initial guess (Chow-Patel): L and U take A's values on their patterns
    l_vals, u_vals = a_vals[lower], a_vals[upper]
    for _ in range(sweeps):
        l_pad = torch.cat([zero, l_vals])
        u_pad = torch.cat([zero, u_vals])
        s = a_vals - (l_pad[dep_l] * u_pad[dep_u]).sum(dim=1)
        u_jj = u_vals[jj]
        u_jj = torch.where(u_jj.abs() > 0, u_jj, torch.ones_like(u_jj))
        l_vals, u_vals = s[lower] / u_jj, s[upper]
    return l_vals, u_vals, st


@dataclasses.dataclass(frozen=True, eq=False)
class _Tables:
    """A structure's index arrays on the factors' device, for the sweeps:
    row offsets of the row-sorted L and U entries, their columns, U's
    diagonal slots and its diagonal mask."""

    l_offsets: torch.Tensor
    l_cols: torch.Tensor
    u_offsets: torch.Tensor
    u_cols: torch.Tensor
    u_diag_slot: torch.Tensor
    u_is_diag: torch.Tensor

    @classmethod
    def of(cls, st: ParILUStructure, device) -> "_Tables":
        def offsets(rows):
            out = np.zeros(st.n + 1, np.int64)
            out[1:] = np.cumsum(np.bincount(rows, minlength=st.n))
            return _on(out, device)

        return cls(offsets(st.l_rows), _on(st.l_cols, device),
                   offsets(st.u_rows), _on(st.u_cols, device),
                   _on(st.u_diag_slot.astype(np.int64), device),
                   _on(st.u_rows == st.u_cols, device))


def _jacobi_lower_solve(tb: _Tables, l_vals, b, sweeps):
    """Solve (I + L) x = b approximately: x <- b - L x, fixed sweeps."""
    x = b
    for _ in range(sweeps):
        x = b - segment_spmv(l_vals, tb.l_offsets, tb.l_cols, x)
    return x


def _jacobi_upper_solve(tb: _Tables, u_vals, b, sweeps):
    """Solve U x = b approximately: x <- D⁻¹ (b - (U - D) x)."""
    diag = u_vals[tb.u_diag_slot]
    safe = torch.where(diag.abs() > 0, diag, torch.ones_like(diag))
    off = torch.where(tb.u_is_diag, 0.0, u_vals)
    x = b / safe
    for _ in range(sweeps):
        x = (b - segment_spmv(off, tb.u_offsets, tb.u_cols, x)) / safe
    return x


def batch_parilu_apply(
    st: ParILUStructure,
    l_vals: torch.Tensor,
    u_vals: torch.Tensor,
    B: torch.Tensor,
    sweeps: int = 8,
) -> torch.Tensor:
    """Batched ``M⁻¹ B ≈ U⁻¹ (I + L)⁻¹ B`` over per-system factors.

    ``l_vals``/``u_vals`` are ``(nb, nl)`` / ``(nb, nu)`` stacks sharing one
    :class:`ParILUStructure`, ``B`` is ``(nb, n)``; each row runs the solo
    apply's Jacobi triangular sweeps.
    """
    tb = _Tables.of(st, B.device)
    diag = torch.gather(u_vals, 1, tb.u_diag_slot[None, :].expand(B.shape[0], -1))
    safe = torch.where(diag.abs() > 0, diag, torch.ones_like(diag))
    off = torch.where(tb.u_is_diag[None, :], 0.0, u_vals)

    def rows_sum(vals, offsets, cols, x):
        # (entries, nb) terms summed over each row's segment
        terms = (vals * x[:, cols]).T
        return torch.segment_reduce(terms, "sum", offsets=offsets, axis=0).T

    y = B
    for _ in range(sweeps):
        y = B - rows_sum(l_vals, tb.l_offsets, tb.l_cols, y)
    x = y / safe
    for _ in range(sweeps):
        x = (y - rows_sum(off, tb.u_offsets, tb.u_cols, x)) / safe
    return x


class ParILU(LinOp):
    """Generated ParILU preconditioner as a LinOp:
    ``M⁻¹ v ≈ U⁻¹ (I + L)⁻¹ v`` by Jacobi triangular sweeps.

    ``storage_bytes`` reports the factor values (L strict-lower + U upper
    entries): the storage the preconditioner owns beyond A.
    """

    def __init__(self, structure: ParILUStructure, l_vals, u_vals,
                 solve_sweeps: int, dtype):
        self.structure = structure
        self.l_vals = l_vals
        self.u_vals = u_vals
        self.solve_sweeps = solve_sweeps
        self._dtype = dtype
        self._tables = _Tables.of(structure, l_vals.device)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.structure.n, self.structure.n)

    @property
    def dtype(self):
        return self._dtype

    @property
    def storage_bytes(self) -> int:
        return sum(v.numel() * v.element_size()
                   for v in (self.l_vals, self.u_vals))

    def _apply(self, v, executor):
        y = _jacobi_lower_solve(self._tables, self.l_vals, v, self.solve_sweeps)
        return _jacobi_upper_solve(self._tables, self.u_vals, y,
                                   self.solve_sweeps)


def parilu_preconditioner(
    A: Csr,
    *,
    factor_sweeps: int = 5,
    solve_sweeps: int = 8,
    structure: ParILUStructure = None,
) -> ParILU:
    """M⁻¹ v ≈ U⁻¹ (I + L)⁻¹ v with iterative sweeps throughout."""
    l_vals, u_vals, st = parilu_factorize(A, structure, sweeps=factor_sweeps)
    return ParILU(st, l_vals, u_vals, solve_sweeps, A.values.dtype)
