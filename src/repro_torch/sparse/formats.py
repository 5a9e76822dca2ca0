"""Sparse matrix formats — Dense, COO, CSR, ELL, SELL-P (Ginkgo's format set).

Each format is a frozen dataclass of tensors plus a static shape, and a
:class:`~repro_torch.core.linop.LinOp` whose apply dispatches through
:func:`repro_torch.sparse.ops.apply`.  Construction and conversion run on the
host in numpy (setup time, like Ginkgo's ``convert_to``); the tensors are then
placed on the requested device, the card unless ``device="cpu"`` is asked for.

ELL is row-major ``(m, max_nnz)``.  Padding entries have column 0 and value 0
(an in-bounds gather that adds nothing), as in the JAX package.  Index arrays
are int32, which is what the CUDA kernels take.

SELL-P groups rows into slices of ``slice_size`` (C, 8 by default) rows; each
slice stores its own column count, padded to a multiple of ``stride_factor``,
column-major within the slice, all slices in one flat buffer with
``slice_sets`` offsets — the JAX package's layout, element for element.  Its
host constructors and readback are vectorised: the JAX package's per-slice,
per-row loops would take minutes at 10⁶ rows.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.executor import default_device
from repro_torch.core.linop import LinOp
from repro_torch.observability import metrics
from repro_torch.observability.trace import span

__all__ = [
    "Dense",
    "Coo",
    "Csr",
    "Ell",
    "Sellp",
    "convert",
    "coo_from_dense",
    "csr_from_arrays",
    "csr_from_dense",
    "ell_from_csr_host",
    "ell_from_dense",
    "sellp_from_csr_host",
    "sellp_from_dense",
    "csr_host_arrays",
    "csr_slice_rows_host",
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

    def astype(self, dtype) -> "MatrixLinOp":
        """Same structure, values cast to ``dtype`` (indices untouched): the
        reduced-precision operator of mixed-precision IR's inner solve."""
        return dataclasses.replace(self, values=self.values.to(dtype))

    def transpose(self):
        """Transpose through the host CSR triplet, rebuilt in this format on
        this matrix's device (setup time).  Dense, COO and CSR override it."""
        indptr, indices, values = csr_host_arrays(self)
        m, n = self.shape
        t = _transpose_host(indptr, indices, values, m, n)
        return convert(csr_from_arrays(*t, (n, m), device=self.values.device),
                       type(self))


@dataclasses.dataclass(frozen=True, eq=False)
class Dense(MatrixLinOp):
    """Row-major dense matrix (gko::matrix::Dense)."""

    values: torch.Tensor  # (m, n)

    def transpose(self) -> "Dense":
        return Dense(self.values.T.contiguous())

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
class Coo(MatrixLinOp):
    """Coordinate format; entries sorted by row, then column."""

    row_idx: torch.Tensor  # (nnz,) int32, sorted
    col_idx: torch.Tensor  # (nnz,) int32
    values: torch.Tensor  # (nnz,)
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    @property
    def memory_bytes(self) -> int:
        return _nbytes(self.row_idx, self.col_idx, self.values)

    def transpose(self) -> "Coo":
        """Swap the indices and restore row order: the order is a host
        lexsort, the values are permuted on their device."""
        r = host_array(self.col_idx).astype(np.int64)
        c = host_array(self.row_idx).astype(np.int64)
        order = np.lexsort((c, r))
        dev = self.values.device
        return Coo(
            row_idx=torch.as_tensor(r[order].astype(np.int32), device=dev),
            col_idx=torch.as_tensor(c[order].astype(np.int32), device=dev),
            values=self.values[torch.as_tensor(order, device=dev)],
            shape=(self.shape[1], self.shape[0]),
        )


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

    def transpose(self) -> "Csr":
        """Transpose through the sorted triplet: the permutation is a host
        lexsort, the values are gathered on their device."""
        indptr = host_array(self.indptr).astype(np.int64)
        indices = host_array(self.indices).astype(np.int64)
        m, n = self.shape
        rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
        order = np.lexsort((rows, indices))
        t_indptr = np.zeros(n + 1, np.int64)
        t_indptr[1:] = np.cumsum(np.bincount(indices, minlength=n))
        dev = self.values.device
        return Csr(
            indptr=torch.as_tensor(t_indptr.astype(np.int32), device=dev),
            indices=torch.as_tensor(rows[order].astype(np.int32), device=dev),
            values=self.values[torch.as_tensor(order, device=dev)],
            shape=(n, m),
        )


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


@dataclasses.dataclass(frozen=True, eq=False)
class Sellp(MatrixLinOp):
    """SELL-P (sliced ELL with padding) — Ginkgo's GPU throughput format.

    Slice ``s`` holds rows ``s*C .. s*C + C - 1`` and ``slice_cols[s]``
    columns (a multiple of ``stride_factor``, at least one); its entries
    occupy ``slice_sets[s]*C : slice_sets[s+1]*C`` of the flat buffers,
    entry (local column j, local row r) at ``slice_sets[s]*C + j*C + r``.
    Padding is (column 0, value 0).
    """

    col_idx: torch.Tensor  # (total,) int32
    values: torch.Tensor  # (total,)
    slice_sets: torch.Tensor  # (num_slices+1,) int32 column offsets
    slice_cols: torch.Tensor  # (num_slices,) int32 padded columns per slice
    shape: Tuple[int, int]
    slice_size: int  # C
    stride_factor: int
    max_slice_cols: int

    @property
    def num_slices(self) -> int:
        return self.slice_cols.shape[0]

    @property
    def nnz(self) -> int:
        """Stored (slice-padded) entries: what the kernel streams."""
        return self.values.numel()

    @property
    def memory_bytes(self) -> int:
        return _nbytes(self.col_idx, self.values, self.slice_sets,
                       self.slice_cols)

    def transpose(self) -> "Sellp":
        """Transpose keeping this matrix's slice size and stride factor."""
        indptr, indices, values = csr_host_arrays(self)
        m, n = self.shape
        t = _transpose_host(indptr, indices, values, m, n)
        return sellp_from_csr_host(*t, (n, m), slice_size=self.slice_size,
                                   stride_factor=self.stride_factor,
                                   device=self.values.device)


def _transpose_host(indptr: np.ndarray, indices: np.ndarray,
                    values: np.ndarray, m: int, n: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Transpose a host CSR triplet of an ``(m, n)`` matrix (setup time)."""
    indices = np.asarray(indices, np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    order = np.lexsort((rows, indices))
    t_indptr = np.zeros(n + 1, np.int64)
    t_indptr[1:] = np.cumsum(np.bincount(indices, minlength=n))
    return t_indptr, rows[order], np.asarray(values)[order]


# -- host-side constructors (setup time, numpy) --------------------------------


def coo_from_dense(a: np.ndarray, *, device=None) -> Coo:
    a = np.asarray(a)
    r, c = np.nonzero(a)  # row-major order: rows sorted, columns within
    dev = _device(device)
    return Coo(
        row_idx=torch.as_tensor(r.astype(np.int32), device=dev),
        col_idx=torch.as_tensor(c.astype(np.int32), device=dev),
        values=torch.as_tensor(a[r, c], device=dev),
        shape=tuple(int(s) for s in a.shape),
    )


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
    """Host CSR -> :class:`Ell` on ``device`` (padding: column 0, value 0),
    in a ``format.convert`` span."""
    with span("format.convert", cat="format", to="ell", rows=int(shape[0])):
        return _ell_from_csr_host(indptr, indices, values, shape, max_nnz,
                                  device)


def _ell_from_csr_host(indptr, indices, values, shape, max_nnz, device) -> Ell:
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


def sellp_from_csr_host(indptr, indices, values, shape, slice_size: int = 8,
                        stride_factor: int = 8, *, device=None) -> Sellp:
    """Host CSR -> :class:`Sellp` on ``device`` with Ginkgo's slice layout.

    An empty matrix gets no slice.  Every slice has at least one column, so
    an all-empty slice stores one padded column.  Runs in a
    ``format.convert`` span and sets the gauges ``sellp_stored_slots`` and
    ``sellp_true_nonzeros`` (the CSR entries), whose ratio is the share of
    the streamed slots that hold an entry.
    """
    with span("format.convert", cat="format", to="sellp", rows=int(shape[0])):
        A = _sellp_from_csr_host(indptr, indices, values, shape, slice_size,
                                 stride_factor, device)
    metrics.gauge("sellp_stored_slots").set(A.nnz)
    ip = np.asarray(indptr)
    metrics.gauge("sellp_true_nonzeros").set(int(ip[-1]) - int(ip[0]))
    return A


def _sellp_from_csr_host(indptr, indices, values, shape, slice_size: int,
                         stride_factor: int, device) -> Sellp:
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices)
    values = np.asarray(values)
    m = int(shape[0])
    C = int(slice_size)
    sf = int(stride_factor)
    num_slices = (m + C - 1) // C
    row_nnz = np.zeros(num_slices * C, np.int64)
    row_nnz[:m] = np.diff(indptr)[:m]
    width = np.maximum(row_nnz.reshape(num_slices, C).max(axis=1, initial=0), 1)
    slice_cols = (((width + sf - 1) // sf) * sf).astype(np.int32)
    slice_sets = np.zeros(num_slices + 1, np.int64)
    slice_sets[1:] = np.cumsum(slice_cols)
    total = int(slice_sets[-1]) * C
    cols = np.zeros(total, np.int32)
    vals = np.zeros(total, values.dtype)
    # CSR entry t of row i, position j in its row, lands at
    # slice_sets[i // C] * C + j * C + i % C
    rows = np.repeat(np.arange(m, dtype=np.int64), row_nnz[:m])
    t = np.arange(indptr[0], indptr[0] + rows.size, dtype=np.int64)
    pos = t - indptr[rows]
    dst = slice_sets[rows // C] * C + pos * C + rows % C
    cols[dst] = indices[t]
    vals[dst] = values[t]
    dev = _device(device)
    return Sellp(
        col_idx=torch.as_tensor(cols, device=dev),
        values=torch.as_tensor(vals, device=dev),
        slice_sets=torch.as_tensor(slice_sets.astype(np.int32), device=dev),
        slice_cols=torch.as_tensor(slice_cols, device=dev),
        shape=tuple(int(s) for s in shape),
        slice_size=C,
        stride_factor=sf,
        max_slice_cols=int(slice_cols.max()) if num_slices else 0,
    )


def sellp_from_dense(a: np.ndarray, slice_size: int = 8, stride_factor: int = 8,
                     *, device=None) -> Sellp:
    a = np.asarray(a)
    r, c = np.nonzero(a)
    indptr = np.zeros(a.shape[0] + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(r, minlength=a.shape[0]))
    return sellp_from_csr_host(indptr, c, a[r, c], a.shape,
                               slice_size=slice_size,
                               stride_factor=stride_factor, device=device)


def _sellp_host_arrays(A: Sellp) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR triplet of a :class:`Sellp`, stored zeros dropped, each row's
    entries in slice-column order.

    The flat buffer viewed as ``(Σ slice_cols, C)`` has row ``r`` of every
    slice in lane (column) ``r``, so a cumulative count down each lane, less
    its value at the slice's first column, ranks an entry within its row.
    """
    m = A.shape[0]
    C = A.slice_size
    slice_sets = host_array(A.slice_sets).astype(np.int64)
    slice_cols = np.diff(slice_sets)
    cols = host_array(A.col_idx).reshape(-1, C)
    vals = host_array(A.values).reshape(-1, C)
    S = slice_cols.size
    slice_of = np.repeat(np.arange(S, dtype=np.int64), slice_cols)
    row = slice_of[:, None] * C + np.arange(C, dtype=np.int64)[None, :]
    keep = (vals != 0) & (row < m)
    before = np.cumsum(keep, axis=0, dtype=np.int64) - keep  # kept above, per lane
    start = before[slice_sets[:-1]] if S else np.zeros((0, C), np.int64)
    rank = before - start[slice_of]
    counts = np.zeros(S * C, np.int64)
    if S:
        counts[:] = (before[slice_sets[1:] - 1] + keep[slice_sets[1:] - 1]
                     - start).reshape(-1)
    indptr = np.zeros(m + 1, np.int64)
    indptr[1:] = np.cumsum(counts[:m])
    dst = indptr[row[keep]] + rank[keep]
    indices = np.zeros(int(indptr[-1]), np.int64)
    values = np.zeros(int(indptr[-1]), vals.dtype)
    indices[dst] = cols[keep]
    values[dst] = vals[keep]
    return indptr, indices, values


def csr_host_arrays(A) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(indptr, indices, values)`` numpy triplet for any format (host-side).

    Explicit stored zeros of the padded formats (ELL and SELL-P padding) are
    dropped: they are storage artifacts, not matrix entries.
    """
    if isinstance(A, Coo):
        r = host_array(A.row_idx).astype(np.int64)
        indptr = np.zeros(A.shape[0] + 1, np.int64)
        indptr[1:] = np.cumsum(np.bincount(r, minlength=A.shape[0]))
        return indptr, host_array(A.col_idx).astype(np.int64), host_array(A.values)
    if isinstance(A, Sellp):
        return _sellp_host_arrays(A)
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


def csr_slice_rows_host(indptr: np.ndarray, indices: np.ndarray,
                        values: np.ndarray, lo: int, hi: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Row block ``[lo, hi)`` of a host CSR triplet (setup time): a CSR over
    ``hi - lo`` rows with indptr rebased to 0, global column indices and each
    row's entry order kept — the split behind the distributed formats."""
    indptr = np.asarray(indptr)
    if not (0 <= lo <= hi <= len(indptr) - 1):
        raise ValueError(
            f"row range [{lo}, {hi}) outside [0, {len(indptr) - 1})"
        )
    start, stop = int(indptr[lo]), int(indptr[hi])
    return (
        (indptr[lo:hi + 1] - start).astype(np.int64),
        np.asarray(indices)[start:stop].astype(np.int64),
        np.asarray(values)[start:stop],
    )


_CONVERT_TARGETS = {
    "coo": Coo,
    "csr": Csr,
    "ell": Ell,
    "sellp": Sellp,
    "dense": Dense,
}


def convert(A, target, **kwargs):
    """Convert any format to another — Ginkgo's ``ConvertibleTo`` surface.

    ``target`` is a format class or name (``"coo"`` / ``"csr"`` / ``"ell"`` /
    ``"sellp"`` / ``"dense"``); ``kwargs`` go to the target's constructor
    (``slice_size`` / ``stride_factor`` for SELL-P, ``max_nnz`` for ELL).
    Conversion runs through the host CSR triplet (dropping stored zeros) and
    places the result on A's device.
    """
    if isinstance(target, str):
        try:
            target = _CONVERT_TARGETS[target.lower()]
        except KeyError:
            raise KeyError(
                f"unknown format {target!r}; known: {sorted(_CONVERT_TARGETS)}"
            ) from None
    if type(A) is target and not kwargs:
        return A
    indptr, indices, values = csr_host_arrays(A)
    m, n = A.shape
    dev = A.values.device
    if target is Csr:
        return csr_from_arrays(indptr, indices, values, (m, n), device=dev)
    if target is Coo:
        rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
        return Coo(
            row_idx=torch.as_tensor(rows.astype(np.int32), device=dev),
            col_idx=torch.as_tensor(indices.astype(np.int32), device=dev),
            values=torch.as_tensor(values, device=dev),
            shape=(m, n),
        )
    if target is Ell:
        return ell_from_csr_host(indptr, indices, values, (m, n), device=dev,
                                 **kwargs)
    if target is Sellp:
        return sellp_from_csr_host(indptr, indices, values, (m, n), device=dev,
                                   **kwargs)
    if target is Dense:
        rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
        dtype = values.dtype if values.size else host_array(A.values).dtype
        out = np.zeros((m, n), dtype)
        np.add.at(out, (rows, indices), values)
        return Dense(torch.as_tensor(out, device=dev))
    raise TypeError(f"unknown conversion target {target!r}")
