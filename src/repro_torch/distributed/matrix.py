"""Row-partitioned matrix formats — gko::experimental::distributed::Matrix.

A distributed matrix splits a square operator ``A`` by rows, one part a rank
of the process group (:class:`~repro_torch.distributed.partition.Partition`).
Each rank stores Ginkgo's local/non-local decomposition of its rows:

* the **local** block — columns inside the rank's own row range, rebased to
  the rank, applied to the rank's own ``x`` shard with no communication;
  split by rows into an **interior** class (rows touching no remote column)
  and a **boundary** class (rows that do);
* the **halo** block — columns owned by other ranks, compressed onto the
  rank's halo column set, applied to the gathered remote entries.

The apply (:class:`LocalOperator`) starts the halo all-gather of the padded
``x`` shards, runs the interior SpMV while it is in flight, waits, then adds
the boundary and halo SpMVs.  Every block SpMV dispatches through the format
registry, so on the card an ELL block reaches the CUDA ``spmv_ell`` kernel.

The host split (:func:`split_by_rows`) and the stacked ``(P, ...)`` arrays
(:func:`stacked_host_arrays`: padded to one shape, padding index 0 and value
0) are the JAX package's arrays; each rank keeps its own row of them on its
device, a CSR block cut to its true entries.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.linop import LinOp
from repro_torch.distributed import comm
from repro_torch.distributed.partition import Partition
from repro_torch.distributed.vector import check_world
from repro_torch.sparse.formats import (
    Csr,
    Ell,
    _device,
    csr_host_arrays,
    csr_slice_rows_host,
)

__all__ = ["DistLinOp", "DistCsr", "DistEll", "LocalOperator",
           "split_by_rows", "stacked_host_arrays"]


# =============================================================================
# Host-side split (setup time, numpy) — Ginkgo's build_local_nonlocal
# =============================================================================


def split_by_rows(indptr, indices, values, partition: Partition) -> List[dict]:
    """Split a host CSR triplet into per-part local + halo blocks.

    One dict a part: ``local`` (the CSR triplet of the part's square
    diagonal block, columns rebased), ``interior`` / ``boundary`` (its rows
    touching no halo column / some; row-disjoint, together ``local``),
    ``halo`` (CSR triplet whose columns index ``halo_cols``) and
    ``halo_cols`` (sorted unique global columns owned by other parts).
    """
    indptr = np.asarray(indptr, np.int64)
    parts = []
    for p in range(partition.num_parts):
        lo, hi = partition.range_of(p)
        ip, j, v = csr_slice_rows_host(indptr, indices, values, lo, hi)
        rows = np.repeat(np.arange(hi - lo, dtype=np.int64), np.diff(ip))
        is_local = (j >= lo) & (j < hi)

        def _triplet(sel, cols, rows=rows, v=v, m=hi - lo):
            counts = np.bincount(rows[sel], minlength=m)
            return (np.concatenate([[0], np.cumsum(counts)]).astype(np.int64),
                    cols, v[sel])

        has_halo = np.zeros(hi - lo, bool)
        has_halo[rows[~is_local]] = True
        is_int = is_local & ~has_halo[rows]
        is_bnd = is_local & has_halo[rows]
        halo_cols = np.unique(j[~is_local])
        parts.append({
            "local": _triplet(is_local, j[is_local] - lo),
            "interior": _triplet(is_int, j[is_int] - lo),
            "boundary": _triplet(is_bnd, j[is_bnd] - lo),
            "halo": _triplet(~is_local, np.searchsorted(halo_cols,
                                                        j[~is_local])),
            "halo_cols": halo_cols,
        })
    return parts


def _stack_csr(triplets, n_rows_pad: int, pad_nnz: int):
    """Per-part CSR triplets -> padded (P, ...) arrays."""
    P = len(triplets)
    indptr = np.zeros((P, n_rows_pad + 1), np.int32)
    indices = np.zeros((P, pad_nnz), np.int32)
    values = np.zeros((P, pad_nnz), triplets[0][2].dtype)
    for p, (ip, j, v) in enumerate(triplets):
        rows = len(ip) - 1
        indptr[p, : rows + 1] = ip
        indptr[p, rows + 1:] = ip[-1]  # padding rows are empty
        indices[p, : len(j)] = j
        values[p, : len(v)] = v
    return indptr, indices, values


def _ell_arrays(ip, j, v, n_rows_pad: int, k: int):
    """One part's CSR triplet -> padded row-major ELL arrays."""
    cols = np.zeros((n_rows_pad, k), np.int32)
    vals = np.zeros((n_rows_pad, k), v.dtype)
    rows = np.repeat(np.arange(len(ip) - 1, dtype=np.int64), np.diff(ip))
    pos = np.arange(len(j), dtype=np.int64) - ip[:-1][rows]
    cols[rows, pos] = j
    vals[rows, pos] = v
    return cols, vals


def _halo_map_padded(parts, partition: Partition) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """Per-part halo column sets as padded-global gather indices: what an
    all-gather of the padded shards holds; padding points at slot 0 and
    pairs with zero values."""
    counts = tuple(len(p["halo_cols"]) for p in parts)
    h_max = max(counts) if counts else 0
    halo_map = np.zeros((partition.num_parts, h_max), np.int32)
    for p, info in enumerate(parts):
        cols = info["halo_cols"]
        halo_map[p, : len(cols)] = partition.padded_index(cols)
    return halo_map, counts


def stacked_host_arrays(fmt: str, indptr, indices, values,
                        partition: Partition) -> Dict[str, np.ndarray]:
    """The JAX package's stacked ``(P, ...)`` arrays of ``DistCsr``
    (``fmt="csr"``) or ``DistEll`` (``"ell"``) for a host CSR triplet, under
    the JAX field names, plus ``halo_counts`` (a tuple)."""
    parts = split_by_rows(indptr, indices, values, partition)
    L = partition.max_part_size
    P = partition.num_parts
    halo_map, counts = _halo_map_padded(parts, partition)
    out: Dict[str, object] = {"halo_map": halo_map, "halo_counts": counts}
    keys = (("int", "interior"), ("bnd", "boundary"), ("halo", "halo"))
    if fmt == "csr":
        for short, key in keys:
            k = max(1, max(len(p[key][2]) for p in parts))
            ip, ix, v = _stack_csr([p[key] for p in parts], L, k)
            out.update({f"{short}_indptr": ip, f"{short}_indices": ix,
                        f"{short}_values": v})
    elif fmt == "ell":
        dtype = np.asarray(values).dtype
        for short, key in keys:
            k = max(1, max((int(np.diff(p[key][0]).max())
                            if len(p[key][0]) > 1 else 0) for p in parts))
            cols = np.zeros((P, L, k), np.int32)
            vals = np.zeros((P, L, k), dtype)
            for p, info in enumerate(parts):
                cols[p], vals[p] = _ell_arrays(*info[key], L, k)
            out.update({f"{short}_col_idx": cols, f"{short}_values": vals})
    else:
        raise ValueError(f"unknown distributed format {fmt!r} (csr | ell)")
    return out


# =============================================================================
# The local operator: one rank's apply
# =============================================================================


class LocalOperator(LinOp):
    """This rank's ``y_l = A_int x_l + A_bnd x_l + A_halo gather(x)[map]``
    on padded ``(Lmax,)`` shards.  ``halo`` is None when no rank touches a
    remote column (then ``interior`` is the whole diagonal block and the
    apply needs no collective)."""

    def __init__(self, interior, boundary, halo, halo_map, *, dtype,
                 executor=None):
        self.interior = interior
        self.boundary = boundary
        self.halo = halo
        self.halo_map = halo_map
        self.shape = interior.shape
        self.dtype = dtype
        self.executor = executor

    @property
    def format_block(self):
        """The format of the blocks (the fused-op probe reads it)."""
        return self.interior

    @property
    def fused_block(self):
        """The one block a fused SpMV + dot may take; None with a halo."""
        return self.interior if self.halo is None else None

    def _apply(self, x, executor):
        from repro_torch.sparse import ops as sparse_ops

        if self.halo is None:
            return sparse_ops.apply(self.interior, x, executor=executor)
        # the collective first, then the interior SpMV while it is in
        # flight; only the boundary and halo terms wait for the gathered x
        pending = comm.all_gather_shards(x, async_op=True)
        y = sparse_ops.apply(self.interior, x, executor=executor)
        xg = pending.wait()
        y = y + sparse_ops.apply(self.boundary, x, executor=executor)
        return y + sparse_ops.apply(self.halo, xg[self.halo_map],
                                    executor=executor)


# =============================================================================
# The distributed LinOps
# =============================================================================


class DistLinOp(LinOp):
    """Base of the row-partitioned operators: this rank's interior, boundary
    and halo blocks and its halo map, and the partition."""

    is_distributed = True

    def __init__(self, interior, boundary, halo, halo_map, *, shape, nnz,
                 partition: Partition, rank: int, halo_counts):
        self.interior = interior
        self.boundary = boundary
        self.halo = halo
        self.halo_map = halo_map  # (H_max,) on the device
        self.shape = tuple(shape)
        self.nnz = int(nnz)
        self.partition = partition
        self.rank = int(rank)
        self._halo_counts = tuple(halo_counts)

    @classmethod
    def from_matrix(cls, A, partition: Partition, *, device=None):
        """Split ``A`` (any format) for this rank of the world, on ``device``
        (``A``'s device when None)."""
        m, n = A.shape
        if m != n:
            raise ValueError("distributed formats row-partition SQUARE "
                             f"operators, got {A.shape}")
        indptr, indices, values = csr_host_arrays(A)
        return cls.from_host(indptr, indices, values, partition,
                             device=A.values.device if device is None
                             else device)

    @classmethod
    def from_host(cls, indptr, indices, values, partition: Partition, *,
                  device=None):
        """Split a square host CSR triplet for this rank of the world."""
        n = len(indptr) - 1
        if partition.global_size != n:
            raise ValueError(
                f"partition covers {partition.global_size} rows but A has {n}")
        fields = stacked_host_arrays(cls._fmt, indptr, indices, values,
                                     partition)
        return cls.from_stacked(fields, shape=(n, n), nnz=len(values),
                                partition=partition, device=device)

    @classmethod
    def from_stacked(cls, fields: Dict[str, np.ndarray], *, shape, nnz,
                     partition: Partition, rank: Optional[int] = None,
                     device=None):
        """This rank's row of the stacked host arrays (the JAX package's
        field names) on ``device``."""
        if rank is None:
            rank = check_world(partition)
        dev = _device(device)
        blocks = cls._blocks(fields, rank, partition.max_part_size, dev)
        halo_map = torch.as_tensor(np.asarray(fields["halo_map"])[rank]
                                   .astype(np.int64), device=dev)
        counts = fields.get("halo_counts")
        if counts is None:
            counts = (halo_map.shape[0],) * partition.num_parts
        return cls(*blocks, halo_map, shape=shape, nnz=nnz,
                   partition=partition, rank=rank, halo_counts=counts)

    # -- the apply protocol ------------------------------------------------------
    def local_operator(self, executor=None) -> LocalOperator:
        halo = self.halo if self.halo_map.shape[0] > 0 else None
        return LocalOperator(
            self.interior, self.boundary if halo is not None else None, halo,
            self.halo_map, dtype=self.dtype, executor=executor)

    def _apply(self, x, executor):
        """Global ``x`` in, global ``y`` out, on every rank."""
        part = self.partition
        y_l = self.local_operator(executor).apply(
            part.pad_part(x, self.rank), executor=executor)
        return part.unpad_flat(comm.all_gather_shards(y_l, kind="gather"))

    # -- reporting -----------------------------------------------------------------
    @property
    def dtype(self):
        return self.interior.values.dtype

    @property
    def num_halo_cols(self) -> Tuple[int, ...]:
        """Halo column count of every part (the communication volume)."""
        return self._halo_counts

    def astype(self, dtype) -> "DistLinOp":
        return type(self)(self.interior.astype(dtype),
                          self.boundary.astype(dtype), self.halo.astype(dtype),
                          self.halo_map, shape=self.shape, nnz=self.nnz,
                          partition=self.partition, rank=self.rank,
                          halo_counts=self._halo_counts)


class DistCsr(DistLinOp):
    """Row-partitioned CSR: this rank's interior, boundary and halo CSR
    blocks, each cut to its true entries."""

    _fmt = "csr"

    @staticmethod
    def _blocks(fields, rank, L, dev):
        h_max = np.asarray(fields["halo_map"]).shape[-1]
        out = []
        for short, width in (("int", L), ("bnd", L), ("halo", h_max)):
            ip = np.asarray(fields[f"{short}_indptr"])[rank]
            nnz = int(ip[-1])
            out.append(Csr(
                indptr=torch.tensor(ip.astype(np.int32), device=dev),
                indices=torch.tensor(np.asarray(
                    fields[f"{short}_indices"])[rank, :nnz].astype(np.int32),
                    device=dev),
                values=torch.tensor(np.ascontiguousarray(np.asarray(
                    fields[f"{short}_values"])[rank, :nnz]), device=dev),
                shape=(L, width)))
        return out

    def local_block(self) -> Csr:
        """This rank's padded square diagonal block as one CSR (interior and
        boundary rows merged on the host): what the preconditioner
        generators take."""
        L = self.partition.max_part_size
        iip = self.interior.indptr.cpu().numpy().astype(np.int64)
        bip = self.boundary.indptr.cpu().numpy().astype(np.int64)
        rows = np.concatenate([
            np.repeat(np.arange(L, dtype=np.int64), np.diff(iip)),
            np.repeat(np.arange(L, dtype=np.int64), np.diff(bip))])
        order = torch.tensor(np.argsort(rows, kind="stable"),
                                device=self.interior.values.device)
        indptr = np.concatenate([[0], np.cumsum(np.diff(iip) + np.diff(bip))])
        return Csr(
            indptr=torch.tensor(indptr.astype(np.int32),
                                   device=self.interior.values.device),
            indices=torch.cat([self.interior.indices,
                               self.boundary.indices])[order],
            values=torch.cat([self.interior.values,
                              self.boundary.values])[order],
            shape=(L, L))


class DistEll(DistLinOp):
    """Row-partitioned ELL: this rank's interior, boundary and halo ELL
    blocks, each class with its own width (the widest row of that class over
    all parts)."""

    _fmt = "ell"

    @staticmethod
    def _blocks(fields, rank, L, dev):
        h_max = np.asarray(fields["halo_map"]).shape[-1]
        return [Ell(
            col_idx=torch.tensor(np.ascontiguousarray(np.asarray(
                fields[f"{short}_col_idx"])[rank]).astype(np.int32),
                device=dev),
            values=torch.tensor(np.ascontiguousarray(np.asarray(
                fields[f"{short}_values"])[rank]), device=dev),
            shape=(L, width))
            for short, width in (("int", L), ("bnd", L), ("halo", h_max))]

    def local_block(self) -> Ell:
        """This rank's padded square diagonal block: interior and boundary
        are row-disjoint, so their widths side by side merge them (the
        inactive class holds only (column 0, value 0) padding)."""
        L = self.partition.max_part_size
        return Ell(torch.cat([self.interior.col_idx, self.boundary.col_idx], 1),
                   torch.cat([self.interior.values, self.boundary.values], 1),
                   shape=(L, L))
