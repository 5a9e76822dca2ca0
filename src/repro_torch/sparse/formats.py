"""Sparse matrix formats — Dense, CSR, ELL (the slice's subset of Ginkgo's set).

Each format is a frozen dataclass of tensors plus a static shape, and a
:class:`~repro_torch.core.linop.LinOp` whose apply dispatches through
:func:`repro_torch.sparse.ops.apply`.  Construction and conversion run on the
host in numpy (setup time, like Ginkgo's ``convert_to``); the tensors are then
placed on the requested device, the card unless ``device="cpu"`` is asked for.

ELL is row-major ``(m, max_nnz)``.  Padding entries have column 0 and value 0
(an in-bounds gather that adds nothing), as in the JAX package.  Index arrays
are int32, which is what the CUDA kernels take.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.executor import default_device
from repro_torch.core.linop import LinOp

__all__ = [
    "Dense",
    "Csr",
    "Ell",
    "csr_from_arrays",
    "csr_from_dense",
    "ell_from_csr_host",
    "ell_from_dense",
    "csr_host_arrays",
    "host_array",
]


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _device(device) -> torch.device:
    return default_device() if device is None else torch.device(device)


def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array (bfloat16 comes back as its uint16
    bit pattern: numpy has no bfloat16 of its own)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


class MatrixLinOp(LinOp):
    """LinOp face shared by the formats: apply dispatches through the
    registry on the executor threaded in from the caller or the ambient."""

    def _apply(self, b, executor):
        from repro_torch.sparse import ops

        return ops.apply(self, b, executor=executor)

    @property
    def dtype(self):
        return self.values.dtype


@dataclasses.dataclass(frozen=True, eq=False)
class Dense(MatrixLinOp):
    """Row-major dense matrix (gko::matrix::Dense)."""

    values: torch.Tensor  # (m, n)

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.values.shape)

    @property
    def nnz(self) -> int:
        return self.values.numel()

    @property
    def memory_bytes(self) -> int:
        return _nbytes(self.values)


@dataclasses.dataclass(frozen=True, eq=False)
class Csr(MatrixLinOp):
    """Compressed sparse row."""

    indptr: torch.Tensor  # (m+1,) int32
    indices: torch.Tensor  # (nnz,) int32
    values: torch.Tensor  # (nnz,)
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    @property
    def memory_bytes(self) -> int:
        return _nbytes(self.indptr, self.indices, self.values)


@dataclasses.dataclass(frozen=True, eq=False)
class Ell(MatrixLinOp):
    """ELLPACK: ``max_nnz`` entries per row, padding (column 0, value 0)."""

    col_idx: torch.Tensor  # (m, max_nnz) int32
    values: torch.Tensor  # (m, max_nnz)
    shape: Tuple[int, int]

    @property
    def max_nnz(self) -> int:
        return self.values.shape[1]

    @property
    def nnz(self) -> int:
        """Stored entries ``m * max_nnz`` (padding is read by the kernel)."""
        return self.values.numel()

    @property
    def memory_bytes(self) -> int:
        return _nbytes(self.col_idx, self.values)


# -- host-side constructors (setup time, numpy) --------------------------------


def csr_from_arrays(indptr, indices, values, shape, *, device=None) -> Csr:
    dev = _device(device)
    return Csr(
        indptr=torch.as_tensor(np.asarray(indptr, np.int32), device=dev),
        indices=torch.as_tensor(np.asarray(indices, np.int32), device=dev),
        values=torch.as_tensor(np.asarray(values), device=dev),
        shape=tuple(int(s) for s in shape),
    )


def csr_from_dense(a: np.ndarray, *, device=None) -> Csr:
    a = np.asarray(a)
    r, c = np.nonzero(a)  # row-major order: rows sorted, columns within
    indptr = np.zeros(a.shape[0] + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(r, minlength=a.shape[0]))
    return csr_from_arrays(indptr, c, a[r, c], a.shape, device=device)


def ell_from_csr_host(indptr, indices, values, shape, max_nnz=None, *,
                      device=None) -> Ell:
    """Host CSR -> :class:`Ell` on ``device`` (padding: column 0, value 0)."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    values = np.asarray(values)
    m = shape[0]
    row_nnz = np.diff(indptr)
    k = int(max_nnz if max_nnz is not None else (row_nnz.max() if m else 0))
    k = max(k, 1)
    bad = np.flatnonzero(row_nnz > k)
    if bad.size:
        raise ValueError(
            f"row {int(bad[0])} has {int(row_nnz[bad[0]])} nnz > max_nnz {k}"
        )
    cols = np.zeros((m, k), np.int32)
    vals = np.zeros((m, k), values.dtype)
    # entry t of the CSR stream lands at (row[t], t - indptr[row[t]])
    rows = np.repeat(np.arange(m, dtype=np.int64), row_nnz)
    pos = np.arange(indices.shape[0], dtype=np.int64) - indptr[:-1][rows]
    cols[rows, pos] = indices
    vals[rows, pos] = values
    dev = _device(device)
    return Ell(
        torch.as_tensor(cols, device=dev),
        torch.as_tensor(vals, device=dev),
        tuple(int(s) for s in shape),
    )


def ell_from_dense(a: np.ndarray, *, device=None) -> Ell:
    a = np.asarray(a)
    r, c = np.nonzero(a)
    indptr = np.zeros(a.shape[0] + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(r, minlength=a.shape[0]))
    return ell_from_csr_host(indptr, c, a[r, c], a.shape, device=device)


def csr_host_arrays(A) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(indptr, indices, values)`` numpy triplet for any format (host-side).

    Explicit stored zeros of the padded format (ELL padding) are dropped:
    they are storage artifacts, not matrix entries.
    """
    if isinstance(A, Csr):
        return (
            host_array(A.indptr).astype(np.int64),
            host_array(A.indices).astype(np.int64),
            host_array(A.values),
        )
    if isinstance(A, Dense):
        a = host_array(A.values)
        r, c = np.nonzero(a)
        indptr = np.zeros(a.shape[0] + 1, np.int64)
        np.add.at(indptr, r + 1, 1)
        return np.cumsum(indptr), c.astype(np.int64), a[r, c]
    if isinstance(A, Ell):
        cols = host_array(A.col_idx)
        vals = host_array(A.values)
        keep = vals != 0
        indptr = np.zeros(A.shape[0] + 1, np.int64)
        indptr[1:] = np.cumsum(keep.sum(axis=1))
        return indptr, cols[keep].astype(np.int64), vals[keep]
    raise TypeError(f"cannot extract a CSR triplet from {type(A)}")
