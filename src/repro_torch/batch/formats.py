"""Batched sparse formats — gko::batch::matrix::{Csr, Ell}.

Systems that share one sparsity pattern and differ in values (chemistry
networks, the cells of a discretised PDE) store **one** index structure and a
value tensor with a leading batch axis:

* :class:`BatchCsr` — shared ``indptr``/``indices``, values ``(nb, nnz)``;
* :class:`BatchEll` — shared ``col_idx (m, k)``, values ``(nb, m, k)``.

Conversion from a list of single-system matrices with different patterns
builds the union pattern on the host (setup time, numpy) and stores explicit
zeros where a system lacks an entry.  Tensors are placed on the requested
device, the card unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.batch.linop import BatchLinOp
from repro_torch.sparse.formats import (
    Csr,
    Ell,
    _device,
    _nbytes,
    csr_from_dense,
    ell_from_dense,
    host_array,
)

__all__ = [
    "BatchCsr",
    "BatchEll",
    "batch_csr_from_list",
    "batch_ell_from_list",
    "batch_csr_from_dense",
    "batch_ell_from_dense",
    "batch_ell_from_batch_csr",
]


class BatchMatrixLinOp(BatchLinOp):
    """Apply dispatches through the batched operation registry."""

    def _apply(self, X, executor):
        from repro_torch.batch import ops

        return ops.apply_batch(self, X, executor=executor)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def num_batch(self) -> int:
        return self.values.shape[0]


@dataclasses.dataclass(frozen=True, eq=False)
class BatchCsr(BatchMatrixLinOp):
    """Batch of CSR matrices sharing one sparsity pattern."""

    indptr: torch.Tensor  # (m+1,) int32, shared
    indices: torch.Tensor  # (nnz,) int32, shared
    values: torch.Tensor  # (nb, nnz)
    shape: Tuple[int, int]  # per system

    @property
    def nnz(self) -> int:
        """Stored entries per system."""
        return self.values.shape[1]

    @property
    def memory_bytes(self) -> int:
        return _nbytes(self.indptr, self.indices, self.values)

    def system(self, i: int) -> Csr:
        """System ``i`` as a single-system :class:`Csr` (a view)."""
        return Csr(self.indptr, self.indices, self.values[i], self.shape)


@dataclasses.dataclass(frozen=True, eq=False)
class BatchEll(BatchMatrixLinOp):
    """Batch of ELL matrices sharing one column-index block; padding is
    (column 0, value 0) in every system."""

    col_idx: torch.Tensor  # (m, max_nnz) int32, shared
    values: torch.Tensor  # (nb, m, max_nnz)
    shape: Tuple[int, int]  # per system

    @property
    def max_nnz(self) -> int:
        return self.values.shape[2]

    @property
    def nnz(self) -> int:
        """Stored entries per system (``m * max_nnz``, padding included)."""
        return self.values.shape[1] * self.values.shape[2]

    @property
    def memory_bytes(self) -> int:
        return _nbytes(self.col_idx, self.values)

    def system(self, i: int) -> Ell:
        return Ell(self.col_idx, self.values[i], self.shape)


# -- host-side constructors (setup time, numpy) --------------------------------


def _check_uniform_shapes(mats: Sequence) -> Tuple[int, int]:
    if not mats:
        raise ValueError("cannot batch an empty list of matrices")
    shape = tuple(mats[0].shape)
    for i, m in enumerate(mats):
        if tuple(m.shape) != shape:
            raise ValueError(
                f"batched systems must share a shape: system 0 is {shape}, "
                f"system {i} is {tuple(m.shape)}"
            )
    return shape


def _target(mats, device) -> torch.device:
    return mats[0].values.device if device is None else _device(device)


def batch_csr_from_list(mats: Sequence[Csr], *, device=None) -> BatchCsr:
    """Stack single-system CSR matrices into one :class:`BatchCsr`.

    Identical patterns stack their values; otherwise every row takes the
    sorted union of the systems' columns, with explicit zeros where a system
    lacks an entry.
    """
    shape = _check_uniform_shapes(mats)
    dev = _target(mats, device)
    ptrs = [host_array(m.indptr).astype(np.int64) for m in mats]
    idxs = [host_array(m.indices).astype(np.int64) for m in mats]
    vals = [host_array(m.values) for m in mats]
    if all(np.array_equal(p, ptrs[0]) and np.array_equal(i, idxs[0])
           for p, i in zip(ptrs[1:], idxs[1:])):
        indptr, indices = ptrs[0], idxs[0]
        values = np.stack(vals)
    else:
        m_rows, n_cols = shape
        # union pattern: every (row, col) any system stores, row-major order
        keys = np.unique(np.concatenate([
            np.repeat(np.arange(m_rows, dtype=np.int64), np.diff(p)) * n_cols + i
            for p, i in zip(ptrs, idxs)]))
        rows, indices = keys // n_cols, keys % n_cols
        indptr = np.zeros(m_rows + 1, np.int64)
        indptr[1:] = np.cumsum(np.bincount(rows, minlength=m_rows))
        values = np.zeros((len(mats), keys.size), vals[0].dtype)
        for b, (p, i, v) in enumerate(zip(ptrs, idxs, vals)):
            own = np.repeat(np.arange(m_rows, dtype=np.int64), np.diff(p)) * n_cols + i
            values[b, np.searchsorted(keys, own)] = v
    return BatchCsr(
        indptr=torch.as_tensor(indptr.astype(np.int32), device=dev),
        indices=torch.as_tensor(indices.astype(np.int32), device=dev),
        values=torch.as_tensor(values, device=dev),
        shape=shape,
    )


def batch_ell_from_list(mats: Sequence[Ell], *, device=None) -> BatchEll:
    """Stack single-system ELL matrices into one :class:`BatchEll`.

    Identical column blocks stack their values; otherwise each row's sorted
    union of stored columns (padding column 0 included), padded to the
    batch-wide widest row, becomes the shared block, and each system's
    entries are added into their slots.
    """
    shape = _check_uniform_shapes(mats)
    dev = _target(mats, device)
    cols = [host_array(m.col_idx).astype(np.int64) for m in mats]
    vals = [host_array(m.values) for m in mats]
    if all(c.shape == cols[0].shape and np.array_equal(c, cols[0])
           for c in cols[1:]):
        return BatchEll(
            col_idx=torch.as_tensor(cols[0].astype(np.int32), device=dev),
            values=torch.as_tensor(np.stack(vals), device=dev),
            shape=shape,
        )
    m_rows, n_cols = shape
    row_cols = [np.unique(np.concatenate([c[r] for c in cols]))
                for r in range(m_rows)]
    k = max((c.size for c in row_cols), default=1)
    col_idx = np.zeros((m_rows, k), np.int32)
    values = np.zeros((len(mats), m_rows, k), vals[0].dtype)
    for r, rc in enumerate(row_cols):
        col_idx[r, :rc.size] = rc
        for b in range(len(mats)):
            # add, so a padding (col 0, value 0) slot cannot clobber a real
            # entry at column 0
            np.add.at(values[b, r], np.searchsorted(rc, cols[b][r]), vals[b][r])
    return BatchEll(
        col_idx=torch.as_tensor(col_idx, device=dev),
        values=torch.as_tensor(values, device=dev),
        shape=shape,
    )


def batch_csr_from_dense(stack: np.ndarray, *, device=None) -> BatchCsr:
    """``(nb, m, n)`` dense stack -> :class:`BatchCsr` on the union pattern."""
    return batch_csr_from_list(
        [csr_from_dense(a, device="cpu") for a in np.asarray(stack)],
        device=_device(device))


def batch_ell_from_dense(stack: np.ndarray, *, device=None) -> BatchEll:
    """``(nb, m, n)`` dense stack -> :class:`BatchEll` on the union pattern."""
    return batch_ell_from_list(
        [ell_from_dense(a, device="cpu") for a in np.asarray(stack)],
        device=_device(device))


def batch_ell_from_batch_csr(A: BatchCsr, max_nnz: Optional[int] = None, *,
                             device=None) -> BatchEll:
    """:class:`BatchCsr` -> :class:`BatchEll` (the shared pattern carries
    over); on A's device unless another is named."""
    dev = A.values.device if device is None else _device(device)
    indptr = host_array(A.indptr).astype(np.int64)
    indices = host_array(A.indices)
    values = host_array(A.values)  # (nb, nnz)
    m = A.shape[0]
    row_nnz = np.diff(indptr)
    k = int(max_nnz if max_nnz is not None else (row_nnz.max() if m else 0))
    k = max(k, 1)
    bad = np.flatnonzero(row_nnz > k)
    if bad.size:
        raise ValueError(
            f"row {int(bad[0])} has {int(row_nnz[bad[0]])} nnz > max_nnz {k}")
    rows = np.repeat(np.arange(m, dtype=np.int64), row_nnz)
    pos = np.arange(rows.size, dtype=np.int64) - indptr[:-1][rows]
    cols = np.zeros((m, k), np.int32)
    vals = np.zeros((values.shape[0], m, k), values.dtype)
    cols[rows, pos] = indices[:rows.size]
    vals[:, rows, pos] = values[:, :rows.size]
    return BatchEll(torch.as_tensor(cols, device=dev),
                    torch.as_tensor(vals, device=dev), tuple(A.shape))
