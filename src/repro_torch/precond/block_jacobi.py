"""Block-Jacobi preconditioner with adaptive per-block storage precision.

The port of the JAX package's ``gko::preconditioner::Jacobi``: diagonal
blocks are discovered and extracted on the host (setup time), inverted by a
batched Gauss–Jordan with partial pivoting on the matrix's device, and applied
through the executor-dispatched ``block_jacobi_apply`` operation (the CUDA
kernel in the ``cuda`` space).

Block discovery and extraction are vectorised numpy here: the JAX package's
per-row Python loops would take minutes at 10⁶ rows.  They give the same
block pointers and the same block tensors.

Adaptive precision (arXiv:2006.16852): each inverted block is stored in the
cheapest precision p with ``kappa * u_p <= tau`` (``kappa`` the block's 1-norm
condition estimate, ``u_p`` the unit roundoff); fp16 needs the inverse's
entries to fit its range, bf16 is the wide-range fallback, else the block
stays in the working precision.  Blocks are grouped into one stacked tensor
per storage class and up-cast inside the apply kernel, so reduced precision
shrinks storage and bandwidth, never the arithmetic.

The batched variant (:class:`BatchBlockJacobi`, gko::batch::preconditioner::
Jacobi with bs > 1) builds one slot table from the batch's shared pattern,
gathers every system's blocks through it, inverts them all in one batch and
applies them through the same ``block_jacobi_apply`` operation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.batch.linop import BatchLinOp
from repro_torch.core import registry
from repro_torch.core.linop import LinOp
from repro_torch.sparse.formats import csr_host_arrays, host_array

__all__ = [
    "ADAPTIVE_TAU",
    "BlockJacobi",
    "BatchBlockJacobi",
    "BatchBlockJacobiPattern",
    "block_jacobi",
    "batch_block_jacobi",
    "batch_block_jacobi_pattern",
    "batch_block_jacobi_blocks",
    "batch_block_jacobi_factors",
    "batch_block_jacobi_from_factors",
    "extract_blocks",
    "invert_blocks",
    "natural_blocks",
    "select_block_precisions",
    "uniform_block_ptrs",
    "unit_roundoff",
]

#: default quality budget for the adaptive storage-precision rule
ADAPTIVE_TAU = 1e-2

#: largest finite fp16 magnitude (bf16 shares f32's exponent range)
_FP16_MAX = 65504.0

# the kernel spaces of the apply register on import
import repro_torch.kernels.block_jacobi.ops  # noqa: E402,F401

block_jacobi_apply_op = registry.operation("block_jacobi_apply")


def unit_roundoff(dtype: torch.dtype) -> float:
    """``u = eps / 2``: fp16 2^-11, bf16 2^-8, f32 2^-24, f64 2^-53."""
    return float(torch.finfo(dtype).eps) / 2.0


# =============================================================================
# Block discovery and extraction (host, setup time, vectorised)
# =============================================================================


def uniform_block_ptrs(n: int, block_size: int) -> np.ndarray:
    """Uniform partition of [0, n) into ceil(n / block_size) blocks."""
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    return np.append(np.arange(0, n, block_size, dtype=np.int64), n)


def _entry_rows(indptr: np.ndarray) -> np.ndarray:
    return np.repeat(np.arange(len(indptr) - 1, dtype=np.int64), np.diff(indptr))


def natural_blocks(A, max_block_size: int = 8) -> np.ndarray:
    """Supervariable-agglomeration block discovery (Ginkgo's natural blocks).

    Consecutive rows join one block while they are coupled — row ``i`` has an
    entry in a column the block spans, or a block row has an entry in column
    ``i`` — and the block stays within ``max_block_size``.  Returns block
    pointers ``(nb+1,)``, equal to the JAX package's row-by-row result.

    Row ``i`` is coupled to a block starting at ``s`` iff ``c[i] >= s``, where
    ``c[i]`` is the larger of the last column before ``i`` in row ``i`` and the
    last row before ``i`` with an entry in column ``i``.  ``c`` is computed
    vectorised; the scan over rows then does O(1) work per row.
    """
    indptr, indices, _ = csr_host_arrays(A)
    n = A.shape[0]
    rows = _entry_rows(indptr)
    below = indices < rows  # entry (i, j) with j < i
    couple = np.full(n, -1, np.int64)
    np.maximum.at(couple, rows[below], indices[below])  # last column < i in row i
    above = (indices > rows) & (indices < n)
    np.maximum.at(couple, indices[above], rows[above])  # last row < i reaching i
    ptrs = [0]
    start = 0
    for i, c in enumerate(couple.tolist()):
        if i and (i - start >= max_block_size or c < start):
            ptrs.append(i)
            start = i
    ptrs.append(n)
    return np.asarray(ptrs, np.int64)


def extract_blocks(A, block_ptrs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Padded diagonal-block tensor ``(nb, bs, bs)`` + per-block sizes.

    Gathered from the sparsity structure, no densification.  Padding rows and
    columns carry an identity diagonal; a structurally empty row inside a real
    block also gets a 1 on the diagonal (it could not be inverted otherwise).
    """
    indptr, indices, values = csr_host_arrays(A)
    block_ptrs = np.asarray(block_ptrs, np.int64)
    sizes = np.diff(block_ptrs)
    nb = len(sizes)
    bs = int(sizes.max()) if nb else 1
    dtype = values.dtype if values.size else np.float32
    blocks = np.zeros((nb, bs, bs), dtype)
    rows = _entry_rows(indptr)
    blk = np.searchsorted(block_ptrs, rows, side="right") - 1
    lo, hi = block_ptrs[blk], block_ptrs[blk + 1]
    keep = (indices >= lo) & (indices < hi)
    blocks[blk[keep], rows[keep] - lo[keep], indices[keep] - lo[keep]] = values[keep]
    local = np.arange(bs)
    pad = local[None, :] >= sizes[:, None]  # (nb, bs)
    empty = ~pad & ~blocks.any(axis=2)
    b, l = np.nonzero(pad | empty)
    blocks[b, l, l] = 1.0
    return blocks, sizes


# =============================================================================
# Batched Gauss-Jordan inversion (on the blocks' device)
# =============================================================================


def invert_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Batched explicit inversion of ``(nb, bs, bs)`` blocks.

    Gauss–Jordan with partial pivoting, one elimination step per column for
    all blocks at once.  Rank-deficient blocks (no usable pivot at some step)
    and non-finite results fall back to the identity.
    """
    nb, bs, _ = blocks.shape
    dev, dtype = blocks.device, blocks.dtype
    eye = torch.eye(bs, dtype=dtype, device=dev)
    aug = torch.cat([blocks, eye.expand(nb, bs, bs)], dim=2)
    ok = torch.ones(nb, dtype=torch.bool, device=dev)
    ar = torch.arange(nb, device=dev)
    local = torch.arange(bs, device=dev)
    for k in range(bs):
        col = aug[:, :, k].abs()
        p = torch.where(local >= k, col, torch.full_like(col, -1.0)).argmax(dim=1)
        rk, rp = aug[:, k].clone(), aug[ar, p].clone()
        aug[:, k] = rp
        aug[ar, p] = rk
        piv = aug[:, k, k]
        usable = piv.abs() > 0
        ok &= usable
        row = aug[:, k] / torch.where(usable, piv, torch.ones_like(piv))[:, None]
        aug[:, k] = row
        factors = aug[:, :, k].clone()
        factors[:, k] = 0.0
        aug = aug - factors[:, :, None] * row[:, None, :]
    inv = aug[:, :, bs:]
    bad = ~ok | ~torch.isfinite(inv).all(dim=2).all(dim=1)
    return torch.where(bad[:, None, None], eye, inv)


# =============================================================================
# Adaptive storage-precision selection (host, setup time)
# =============================================================================


def _masked_norm1(t: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Per-block 1-norm restricted to each block's true (size, size) corner."""
    idx = np.arange(t.shape[1])
    valid = idx[None, :] < sizes[:, None]
    masked = np.abs(t) * valid[:, :, None] * valid[:, None, :]
    return masked.sum(axis=1).max(axis=1)


def select_block_precisions(blocks: np.ndarray, inv_blocks: np.ndarray,
                            sizes: np.ndarray, *, tau: float = ADAPTIVE_TAU
                            ) -> np.ndarray:
    """Per-block storage class: 0 = working precision, 1 = bf16, 2 = fp16."""
    kappa = np.maximum(
        _masked_norm1(blocks, sizes) * _masked_norm1(inv_blocks, sizes), 1.0
    )
    maxabs = np.abs(inv_blocks).reshape(len(blocks), -1).max(axis=1)
    fits_fp16 = ((kappa * unit_roundoff(torch.float16) <= tau)
                 & (maxabs < _FP16_MAX))
    fits_bf16 = kappa * unit_roundoff(torch.bfloat16) <= tau
    return np.where(fits_fp16, 2, np.where(fits_bf16, 1, 0)).astype(np.int32)


def _storage_classes(base: torch.dtype) -> Tuple[torch.dtype, ...]:
    return (base, torch.bfloat16, torch.float16)


def _class_ids(adaptive, blocks_np, inv_np, sizes, tau, base) -> np.ndarray:
    nb = len(blocks_np)
    if adaptive is False or adaptive is None:
        return np.zeros(nb, np.int32)
    if adaptive is True:
        return select_block_precisions(blocks_np, inv_np, sizes, tau=tau)
    forced = getattr(torch, adaptive, None) if isinstance(adaptive, str) else adaptive
    for cid, d in enumerate(_storage_classes(base)):
        if d == forced:
            return np.full(nb, cid, np.int32)
    raise ValueError(
        f"adaptive={adaptive!r} is not a supported storage dtype "
        f"(expected True/False or one of {_storage_classes(base)})"
    )


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


# =============================================================================
# The preconditioner
# =============================================================================


def _apply_classes(inv_blocks, flat: torch.Tensor, executor) -> torch.Tensor:
    """``block_jacobi_apply`` on consecutive class slices of ``flat``."""
    outs = []
    off = 0
    for t in inv_blocks:
        nbc = t.shape[0]
        outs.append(block_jacobi_apply_op(t, flat[off:off + nbc],
                                          executor=executor))
        off += nbc
    return torch.cat(outs)


@dataclasses.dataclass(frozen=True, eq=False)
class BlockJacobi(LinOp):
    """Generated block-Jacobi preconditioner: ``M^{-1} v`` via inverted blocks.

    ``inv_blocks`` holds one stacked tensor per storage precision present, in
    class order; ``gather_idx`` / ``scatter_idx`` map vector rows to (block,
    local row) slots in that order (``n`` is the zero-pad slot).
    """

    inv_blocks: Tuple[torch.Tensor, ...]
    gather_idx: torch.Tensor  # (nb, bs) int64
    scatter_idx: torch.Tensor  # (n,) int64 into the flat (nb*bs,) output
    n: int
    block_size: int
    num_blocks: int
    executor: Optional[object] = None

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.inv_blocks[0].dtype if self.inv_blocks else None

    @property
    def precision_counts(self) -> Tuple[Tuple[str, int], ...]:
        return tuple((_dtype_name(t), int(t.shape[0])) for t in self.inv_blocks)

    @property
    def storage_bytes(self) -> int:
        """Bytes held by the inverted-block storage (the adaptive metric)."""
        return sum(t.numel() * t.element_size() for t in self.inv_blocks)

    def _apply(self, v: torch.Tensor, executor) -> torch.Tensor:
        if not self.inv_blocks:  # degenerate 0-row system
            return v
        vp = torch.cat([v, v.new_zeros(1)])[self.gather_idx]  # (nb, bs)
        y = _apply_classes(self.inv_blocks, vp, executor)
        return y.reshape(-1)[self.scatter_idx]


def block_jacobi(
    A,
    block_size: Optional[int] = None,
    *,
    blocks: Optional[Sequence[int]] = None,
    adaptive: Union[bool, str, torch.dtype] = False,
    tau: float = ADAPTIVE_TAU,
    executor=None,
) -> BlockJacobi:
    """Generate the block-Jacobi preconditioner for ``A`` on A's device.

    ``blocks`` pins explicit block pointers (e.g. from :func:`natural_blocks`);
    otherwise the partition is uniform with ``block_size`` (default: the
    executor's subgroup width).  ``adaptive=True`` selects per-block storage
    precision; a dtype (or its name) forces every block into that storage.
    """
    n = A.shape[0]
    if blocks is not None:
        block_ptrs = np.asarray(blocks, np.int64)
        if (block_ptrs[0] != 0 or block_ptrs[-1] != n
                or (np.diff(block_ptrs) <= 0).any()):
            raise ValueError(
                f"block pointers must cover [0, {n}) with positive sizes, "
                f"got {block_ptrs}"
            )
    else:
        if block_size is None:
            from repro_torch.core.executor import current_executor

            ex = executor if executor is not None else current_executor()
            block_size = ex.hw.subgroup_size
        block_ptrs = uniform_block_ptrs(n, block_size)

    dev = A.values.device
    blocks_np, sizes = extract_blocks(A, block_ptrs)
    nb, bs = blocks_np.shape[0], blocks_np.shape[1]
    inv = invert_blocks(torch.as_tensor(blocks_np, device=dev))
    inv_np = inv.cpu().numpy()

    class_id = _class_ids(adaptive, blocks_np, inv_np, sizes, tau, inv.dtype)
    order = np.argsort(class_id, kind="stable")

    # gather/scatter maps in class order
    gather = np.full((nb, bs), n, np.int64)
    scatter = np.zeros(n, np.int64)
    pos_of_block = np.empty(nb, np.int64)
    pos_of_block[order] = np.arange(nb)
    local = np.arange(bs)
    in_block = local[None, :] < sizes[order][:, None]  # (nb, bs) in class order
    rows = block_ptrs[order][:, None] + local[None, :]
    gather[in_block] = rows[in_block]
    all_rows = np.arange(n)
    row_blk = np.searchsorted(block_ptrs, all_rows, side="right") - 1
    scatter[:] = pos_of_block[row_blk] * bs + (all_rows - block_ptrs[row_blk])

    tensors = []
    sorted_ids = class_id[order]
    for cid, dtype in enumerate(_storage_classes(inv.dtype)):
        members = order[sorted_ids == cid]
        if len(members):
            tensors.append(inv[torch.as_tensor(members, device=dev)].to(dtype))

    return BlockJacobi(
        inv_blocks=tuple(tensors),
        gather_idx=torch.as_tensor(gather, device=dev),
        scatter_idx=torch.as_tensor(scatter, device=dev),
        n=n,
        block_size=bs,
        num_blocks=nb,
        executor=executor,
    )


# =============================================================================
# Batched variant — gko::batch::preconditioner::Jacobi with bs > 1
# =============================================================================


@dataclasses.dataclass(frozen=True, eq=False)
class BatchBlockJacobi(BatchLinOp):
    """Per-system block-Jacobi over a shared-pattern batch — a BatchLinOp.

    The blocks of all systems form one class-ordered stack (each storage
    class's sub-batch spans the whole batch), so the apply is the same
    ``block_jacobi_apply`` as the single-system path: one launch per class.
    """

    inv_blocks: Tuple[torch.Tensor, ...]  # per class, (count, bs, bs)
    perm: torch.Tensor  # (ns*nblocks,) int64: class order -> (system, block)
    inv_perm: torch.Tensor  # its inverse
    gather_idx: torch.Tensor  # (nblocks, bs) int64 into a padded system row
    n: int
    num_blocks: int  # per system
    block_size: int
    executor: Optional[object] = None

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def num_batch(self) -> int:
        return self.perm.shape[0] // max(self.num_blocks, 1)

    @property
    def dtype(self):
        return self.inv_blocks[0].dtype if self.inv_blocks else None

    @property
    def storage_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.inv_blocks)

    @property
    def precision_counts(self) -> Tuple[Tuple[str, int], ...]:
        return tuple((_dtype_name(t), int(t.shape[0])) for t in self.inv_blocks)

    def _apply(self, V: torch.Tensor, executor) -> torch.Tensor:
        ns = V.shape[0]
        vp = torch.cat([V, V.new_zeros(ns, 1)], dim=1)[:, self.gather_idx]
        flat = vp.reshape(ns * self.num_blocks, self.block_size)[self.perm]
        y = _apply_classes(self.inv_blocks, flat, executor)[self.inv_perm]
        return y.reshape(ns, self.num_blocks * self.block_size)[:, :self.n]


def _batch_slot_table(A, block_ptrs: np.ndarray, bs: int) -> np.ndarray:
    """``(nblocks, bs, bs)`` table of flat value slots, +1 (0: structurally
    absent), built once from the shared pattern.  An ELL padding slot
    (column 0 past the row's first slot) never claims a table entry."""
    from repro_torch.batch.formats import BatchCsr, BatchEll

    nb = len(block_ptrs) - 1
    table = np.zeros((nb, bs, bs), np.int64)
    if isinstance(A, BatchCsr):
        indptr = host_array(A.indptr).astype(np.int64)
        cols = host_array(A.indices).astype(np.int64)
        rows = _entry_rows(indptr)
        slots = np.arange(1, rows.size + 1, dtype=np.int64)
    elif isinstance(A, BatchEll):
        c = host_array(A.col_idx).astype(np.int64)
        m, k = c.shape
        rows = np.repeat(np.arange(m, dtype=np.int64), k)
        q = np.tile(np.arange(k, dtype=np.int64), m)
        cols = c.reshape(-1)
        slots = rows * k + q + 1
        real = (cols != 0) | (q == 0)
        rows, cols, slots = rows[real], cols[real], slots[real]
    else:
        raise TypeError(f"unknown batched format {type(A)}")
    blk = np.searchsorted(block_ptrs, rows, side="right") - 1
    lo, hi = block_ptrs[blk], block_ptrs[blk + 1]
    inb = (cols >= lo) & (cols < hi)
    table[blk[inb], (rows - lo)[inb], (cols - lo)[inb]] = slots[inb]
    return table


@dataclasses.dataclass(frozen=True, eq=False)
class BatchBlockJacobiPattern:
    """The values-independent half of batched block-Jacobi generation, built
    once per sparsity pattern."""

    block_ptrs: np.ndarray  # (nblocks+1,) host
    sizes: np.ndarray  # (nblocks,) true block sizes
    slot_table: torch.Tensor  # (nblocks, bs, bs) int64 value slots (+1)
    pad_add: torch.Tensor  # (nblocks, bs, bs) f32 identity on the padding
    gather_idx: torch.Tensor  # (nblocks, bs) int64 into a padded system row
    n: int
    num_blocks: int
    block_size: int


def batch_block_jacobi_pattern(A, block_size: Optional[int] = None, *,
                               executor=None) -> BatchBlockJacobiPattern:
    """Pattern tier: uniform blocks, the slot table, the gather map — on A's
    device, no value read."""
    n = A.shape[0]
    if block_size is None:
        from repro_torch.core.executor import current_executor

        ex = executor if executor is not None else current_executor()
        block_size = ex.hw.subgroup_size
    block_ptrs = uniform_block_ptrs(n, block_size)
    sizes = np.diff(block_ptrs)
    nb = len(sizes)
    bs = int(sizes.max()) if nb else 1
    dev = A.values.device
    table = _batch_slot_table(A, block_ptrs, bs)
    local = np.arange(bs)
    pad = (local[None, :] >= sizes[:, None]).astype(np.float32)  # (nb, bs)
    pad_add = pad[:, :, None] * np.eye(bs, dtype=np.float32)
    rows = block_ptrs[:-1, None] + local[None, :]
    gather = np.where(local[None, :] < sizes[:, None], rows, n)
    return BatchBlockJacobiPattern(
        block_ptrs=block_ptrs,
        sizes=sizes,
        slot_table=torch.as_tensor(table, device=dev),
        pad_add=torch.as_tensor(pad_add, device=dev),
        gather_idx=torch.as_tensor(gather.astype(np.int64), device=dev),
        n=n,
        num_blocks=nb,
        block_size=bs,
    )


def batch_block_jacobi_blocks(values: torch.Tensor,
                              pattern: BatchBlockJacobiPattern) -> torch.Tensor:
    """Per-system diagonal blocks ``(ns*nblocks, bs, bs)`` gathered from an
    ``(ns, ...)`` value tensor through the pattern's slot table.

    A block row that gathered only zeros (a structurally empty row, or a
    system whose stored entries there are zero) gets a 1 on the diagonal, the
    single-system extraction's rule; the check looks at the gathered values,
    since an ELL padding slot at the row's first position looks like a real
    column-0 entry.
    """
    ns = values.shape[0]
    nb, bs = pattern.num_blocks, pattern.block_size
    flat = values.reshape(ns, -1)
    padded = torch.cat([flat.new_zeros(ns, 1), flat], dim=1)
    blocks = padded[:, pattern.slot_table.reshape(-1)].reshape(ns, nb, bs, bs)
    blocks = blocks + pattern.pad_add.to(blocks.dtype)[None]
    row_zero = (blocks == 0).all(dim=3)  # (ns, nb, bs)
    eye = torch.eye(bs, dtype=blocks.dtype, device=blocks.device)
    blocks = blocks + row_zero[..., None] * eye
    return blocks.reshape(ns * nb, bs, bs)


def batch_block_jacobi_factors(values: torch.Tensor,
                               pattern: BatchBlockJacobiPattern) -> torch.Tensor:
    """Values tier: gather the blocks and invert them in one batch."""
    return invert_blocks(batch_block_jacobi_blocks(values, pattern))


def batch_block_jacobi_from_factors(inv: torch.Tensor, ns: int,
                                    pattern: BatchBlockJacobiPattern, *,
                                    executor=None) -> BatchBlockJacobi:
    """The BatchLinOp over precomputed inverted blocks: one storage class,
    the identity permutation (what :func:`batch_block_jacobi` builds with
    ``adaptive=False``)."""
    ar = torch.arange(ns * pattern.num_blocks, device=inv.device)
    return BatchBlockJacobi(
        inv_blocks=(inv,),
        perm=ar,
        inv_perm=ar,
        gather_idx=pattern.gather_idx,
        n=pattern.n,
        num_blocks=pattern.num_blocks,
        block_size=pattern.block_size,
        executor=executor,
    )


def batch_block_jacobi(
    A,
    block_size: Optional[int] = None,
    *,
    adaptive: Union[bool, str, torch.dtype] = False,
    tau: float = ADAPTIVE_TAU,
    executor=None,
) -> BatchBlockJacobi:
    """Per-system block-Jacobi for a shared-pattern batched matrix: the
    pattern tier, then the values tier; ``adaptive`` as in
    :func:`block_jacobi`, per (system, block)."""
    ns = A.num_batch
    pattern = batch_block_jacobi_pattern(A, block_size, executor=executor)
    flat_blocks = batch_block_jacobi_blocks(A.values.reshape(ns, -1), pattern)
    inv = invert_blocks(flat_blocks)
    if adaptive is False or adaptive is None:
        return batch_block_jacobi_from_factors(inv, ns, pattern,
                                               executor=executor)
    inv_np = inv.cpu().numpy()
    class_id = _class_ids(adaptive, flat_blocks.cpu().numpy(), inv_np,
                          np.tile(pattern.sizes, ns), tau, inv.dtype)
    order = np.argsort(class_id, kind="stable")
    inv_perm = np.empty_like(order)
    inv_perm[order] = np.arange(len(order))
    dev = inv.device
    tensors = []
    sorted_ids = class_id[order]
    for cid, dtype in enumerate(_storage_classes(inv.dtype)):
        members = order[sorted_ids == cid]
        if len(members):
            tensors.append(inv[torch.as_tensor(members, device=dev)].to(dtype))
    return BatchBlockJacobi(
        inv_blocks=tuple(tensors),
        perm=torch.as_tensor(order.astype(np.int64), device=dev),
        inv_perm=torch.as_tensor(inv_perm.astype(np.int64), device=dev),
        gather_idx=pattern.gather_idx,
        n=pattern.n,
        num_blocks=pattern.num_blocks,
        block_size=pattern.block_size,
        executor=executor,
    )
