"""Executor-dispatched sparse operations (SpMV per format) + BLAS-1.

* ``reference`` space — sequential-semantics formulations (scatter-add CSR);
* ``torch`` space     — portable torch formulations (the JAX package's XLA);
* ``cuda`` space      — registered by :mod:`repro_torch.kernels` for the ops
  that have a Pallas kernel in the JAX package: ``spmv_ell``, ``spmv_sellp``,
  ``spmv_dot_ell``, ``axpy_norm``, ``spgemm``, ``sptranspose`` (and
  ``block_jacobi_apply``, ``spmv_batch_ell``).  The other ops here have no
  kernel there either, and a CUDA executor serves them from the torch space
  on CUDA tensors.

``apply(A, x)`` mirrors ``gko::LinOp::apply``: dispatch on the format, then on
the executor's kernel space.

Contract of the fused ops (as in the JAX package): in the reference and torch
spaces ``spmv_dot_*`` and ``axpy_norm`` are the literal unfused composition
(SpMV then ``dot``; ``axpy`` then ``dot``), so a solver's fused and unfused
paths give bitwise-equal results there.  The cuda kernels sum in another order
and agree within rounding.
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.kernels.axpy_norm.kernel import axpy_norm_plain
from repro_torch.kernels.spgemm.kernel import (
    csr_permute_plain,
    spgemm_expand_plain,
    spgemm_merge_plain,
)
from repro_torch.kernels.spmv_ell.kernel import spmv_ell_plain
from repro_torch.kernels.spmv_sellp.kernel import (
    sellp_slice_of_column,
    spmv_sellp_plain,
)
from repro_torch.observability.trace import span
from repro_torch.sparse.formats import (
    Coo,
    Csr,
    Dense,
    Ell,
    MatrixLinOp,
    Sellp,
    csr_from_arrays,
    host_array,
)

__all__ = [
    "apply",
    "to_dense",
    "spgemm",
    "sptranspose",
    "dot",
    "axpy",
    "scal",
    "norm2",
    "dot_batch",
    "segment_spmv",
    "spmv_dot",
    "axpy_norm",
    "has_fused_ops",
    "distributed_blas",
]

# =============================================================================
# SpMV
# =============================================================================

spmv_coo = registry.operation("spmv_coo", "y = A @ x for sorted COO")
spmv_csr = registry.operation("spmv_csr", "y = A @ x for CSR")
spmv_ell = registry.operation("spmv_ell", "y = A @ x for ELLPACK")
spmv_sellp = registry.operation("spmv_sellp", "y = A @ x for SELL-P")
spmv_dense = registry.operation("spmv_dense", "y = A @ x (dense)")


def _scatter_rows(A, rows, cols, x):
    """y[rows[t]] += values[t] * x[cols[t]]: the scatter-add SpMV of COO and
    CSR (one or several right-hand sides), entry by entry (sequential
    semantics; on a CUDA tensor ``index_add_`` adds with atomics)."""
    y = torch.zeros((A.shape[0],) + tuple(x.shape[1:]),
                    dtype=torch.promote_types(A.values.dtype, x.dtype),
                    device=x.device)
    vals = A.values[:, None] if x.ndim == 2 else A.values
    return y.index_add_(0, rows, vals * x[cols])


def segment_spmv(values, offsets, cols, x):
    """y[r] = sum of values[t] * x[cols[t]] over t in [offsets[r],
    offsets[r + 1]): the torch space's COO / CSR SpMV, and ParILU's
    triangular sweeps.  Each row is one segment summed in a fixed order with
    no atomics, so a product repeats bit for bit on the card; on the CPU the
    sums are the scatter-add's.  The terms are always 2-D (entries,
    right-hand sides): on the card each row's sum is then one thread's loop,
    where 1-D terms would take one block of a segmented reduction per row,
    slow for many short rows."""
    vals = values[:, None]
    contrib = vals * x[cols] if x.ndim == 2 else vals * x[cols][:, None]
    y = torch.segment_reduce(contrib, "sum", offsets=offsets, axis=0)
    return y if x.ndim == 2 else y[:, 0]



def _coo_offsets(A: Coo) -> torch.Tensor:
    """``(m + 1,)`` int64: where each row starts among A's sorted entries."""
    rows = torch.arange(A.shape[0] + 1, dtype=A.row_idx.dtype,
                        device=A.row_idx.device)
    return torch.searchsorted(A.row_idx, rows)


@spmv_coo.register("reference")
def _spmv_coo_ref(ex, A: Coo, x):
    return _scatter_rows(A, A.row_idx.long(), A.col_idx, x)


@spmv_coo.register("torch")
def _spmv_coo_torch(ex, A: Coo, x):
    return segment_spmv(A.values, _coo_offsets(A), A.col_idx, x)


def _csr_row_ids(A: Csr) -> torch.Tensor:
    counts = (A.indptr[1:] - A.indptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(A.shape[0], device=A.values.device), counts
    )


@spmv_csr.register("reference")
def _spmv_csr_ref(ex, A: Csr, x):
    return _scatter_rows(A, _csr_row_ids(A), A.indices, x)


@spmv_csr.register("torch")
def _spmv_csr_torch(ex, A: Csr, x):
    return segment_spmv(A.values, A.indptr, A.indices, x)


def _spmv_ell_plain(ex, A: Ell, x):
    """One right-hand side, or X (n, r): the gather x[col_idx] (m, k, r)
    contracted over k.  Each right-hand side's terms are laid out (r, m, k)
    and summed over their last axis, as the 1-D call sums its (m, k) terms,
    so every column of Y is the 1-D call's on that column of X."""
    if x.ndim == 1:
        return spmv_ell_plain(A.col_idx, A.values, x)
    terms = x[A.col_idx].permute(2, 0, 1).contiguous()  # (r, m, k)
    return (A.values * terms).sum(dim=-1).t().contiguous()


spmv_ell.register("reference")(_spmv_ell_plain)
spmv_ell.register("torch")(_spmv_ell_plain)


@spmv_sellp.register("reference")
def _spmv_sellp_ref(ex, A: Sellp, x):
    """Oracle: the slice layout read back one slice at a time (Ginkgo's
    reference kernel)."""
    if x.ndim != 1:
        raise NotImplementedError("SELL-P spmv takes one right-hand side")
    C = A.slice_size
    y = torch.zeros(A.num_slices * C, dtype=torch.promote_types(A.dtype, x.dtype),
                    device=x.device)
    sets = host_array(A.slice_sets).tolist()
    for s, (lo, hi) in enumerate(zip(sets[:-1], sets[1:])):
        block_v = A.values[lo * C:hi * C].view(hi - lo, C)
        block_c = A.col_idx[lo * C:hi * C].view(hi - lo, C)
        y[s * C:(s + 1) * C] = (block_v * x[block_c]).sum(dim=0)
    return y[:A.shape[0]]


@spmv_sellp.register("torch")
def _spmv_sellp_torch(ex, A: Sellp, x):
    if x.ndim != 1:
        raise NotImplementedError("SELL-P spmv takes one right-hand side")
    return spmv_sellp_plain(A.col_idx, A.values, A.slice_sets, x, A.shape[0],
                            A.slice_size)


def _spmv_dense_plain(ex, A: Dense, x):
    return A.values @ x


spmv_dense.register("reference")(_spmv_dense_plain)
spmv_dense.register("torch")(_spmv_dense_plain)


_FORMAT_OP = {
    Coo: spmv_coo,
    Csr: spmv_csr,
    Ell: spmv_ell,
    Sellp: spmv_sellp,
    Dense: spmv_dense,
}


def apply(A, x: torch.Tensor, *, executor=None) -> torch.Tensor:
    """``A.apply(x)``: format dispatch, then executor dispatch.

    Non-format LinOps (``Sum``, ``Composition``, preconditioners, ...) use
    their own ``apply``.
    """
    op = _FORMAT_OP.get(type(A))
    if op is None:
        from repro_torch.core.linop import LinOp

        if isinstance(A, LinOp) and not isinstance(A, MatrixLinOp):
            return A.apply(x, executor=executor)
        raise TypeError(f"no spmv registered for format {type(A)}")
    m, n = A.shape
    if m == 0 or n == 0:
        # no kernel may launch, and the ELL padding has no column 0 to gather
        return torch.zeros((m,) + tuple(x.shape[1:]),
                           dtype=torch.promote_types(A.dtype, x.dtype),
                           device=x.device)
    return op(A, x, executor=executor)


to_dense_op = registry.operation("sparse_to_dense", "densify any format")


def sellp_rows(A: Sellp) -> torch.Tensor:
    """``(total,)`` int64: the row of every entry of A's flat buffer (rows
    past ``m`` in the last slice hold only padding)."""
    C = A.slice_size
    slice_of = sellp_slice_of_column(A.slice_sets, A.values.numel() // C)
    lanes = torch.arange(C, device=A.values.device)
    return (slice_of[:, None] * C + lanes[None, :]).reshape(-1)


def _to_dense(ex, A):
    if isinstance(A, Dense):
        return A.values
    out = torch.zeros(A.shape, dtype=A.values.dtype, device=A.values.device)
    if isinstance(A, Coo):
        return out.index_put_((A.row_idx.long(), A.col_idx.long()), A.values,
                              accumulate=True)
    if isinstance(A, Csr):
        return out.index_put_((_csr_row_ids(A), A.indices.long()), A.values,
                              accumulate=True)
    if isinstance(A, Sellp):
        rows = sellp_rows(A)
        keep = rows < A.shape[0]
        return out.index_put_((rows[keep], A.col_idx[keep].long()),
                              A.values[keep], accumulate=True)
    if isinstance(A, Ell):
        m, k = A.values.shape
        rows = torch.arange(m, device=A.values.device).repeat_interleave(k)
        return out.index_put_((rows, A.col_idx.reshape(-1).long()),
                              A.values.reshape(-1), accumulate=True)
    raise TypeError(f"unknown format {type(A)}")


to_dense_op.register("reference")(_to_dense)
to_dense_op.register("torch")(_to_dense)


def to_dense(A, *, executor=None) -> torch.Tensor:
    """The dense ``(m, n)`` tensor of a matrix in any format."""
    if 0 in A.shape:
        return torch.zeros(A.shape, dtype=A.dtype, device=A.values.device)
    return to_dense_op(A, executor=executor)


# =============================================================================
# BLAS-1
# =============================================================================

dot_op = registry.operation("blas_dot")
axpy_op = registry.operation("blas_axpy")
scal_op = registry.operation("blas_scal")
norm2_op = registry.operation("blas_norm2")


def _dot(ex, x, y):
    return torch.dot(x, y)


def _axpy(ex, alpha, x, y):
    return alpha * x + y


def _scal(ex, alpha, x):
    return alpha * x


def _norm2(ex, x):
    return torch.sqrt(torch.dot(x, x))


for _space in ("reference", "torch"):
    dot_op.register(_space)(_dot)
    axpy_op.register(_space)(_axpy)
    scal_op.register(_space)(_scal)
    norm2_op.register(_space)(_norm2)


def dot(x, y, *, executor=None):
    ctx = _DIST_BLAS.get()
    if ctx is None:
        return dot_op(x, y, executor=executor)
    # mask both operands: 0 * a non-finite padding slot would still be NaN
    mask = ctx.mask
    return ctx.sum(dot_op(_masked(x, mask), _masked(y, mask),
                          executor=executor))


def axpy(alpha, x, y, *, executor=None):
    return axpy_op(alpha, x, y, executor=executor)


def scal(alpha, x, *, executor=None):
    return scal_op(alpha, x, executor=executor)


def norm2(x, *, executor=None):
    ctx = _DIST_BLAS.get()
    if ctx is None:
        return norm2_op(x, executor=executor)
    # the local sum of squares through the dispatched dot, the sum over
    # ranks, one sqrt: the global norm Stop.threshold expects
    xm = _masked(x, ctx.mask)
    return torch.sqrt(ctx.sum(dot_op(xm, xm, executor=executor)))


def dot_batch(pairs, *, executor=None):
    """Batched dot products: ``[(x₁, y₁), ...] -> (len(pairs),)``.

    The communication-avoiding reduction pipelined Krylov methods
    restructure their recurrences for: under the distributed context the
    local partials are stacked and summed over the ranks in ONE collective,
    not one a dot.  Outside it, the stacked local dots.
    """
    ctx = _DIST_BLAS.get()
    if ctx is None:
        return torch.stack([dot_op(x, y, executor=executor) for x, y in pairs])
    mask = ctx.mask
    return ctx.sum(torch.stack([
        dot_op(_masked(x, mask), _masked(y, mask), executor=executor)
        for x, y in pairs]))


# -- the distributed-reduction context -----------------------------------------
#
# Inside a distributed solve every vector is this rank's padded shard of the
# global vector: ``dot``/``norm2``/``dot_batch`` and the fused ops reduce
# locally (still executor-dispatched), with the padding slots masked, and
# then sum over the ranks (``comm.sum_fixed``, the same bits on every rank).
# :func:`repro_torch.distributed.dist_solve` opens this context around the
# unchanged solver source.  ``axpy``/``scal`` are elementwise and need no
# collective.


class _DistBlas:
    __slots__ = ("mask",)

    def __init__(self, mask):
        self.mask = mask

    @staticmethod
    def sum(local: torch.Tensor) -> torch.Tensor:
        from repro_torch.distributed import comm

        return comm.sum_fixed(local)


_DIST_BLAS: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_distributed_blas", default=None
)


@contextlib.contextmanager
def distributed_blas(mask=None):
    """Make ``dot``/``norm2``/``dot_batch``/``spmv_dot``/``axpy_norm``
    global over the ranks of the default process group, with this rank's
    padding slots masked by ``mask`` (bool tensor; ``None`` for a shard
    without padding)."""
    token = _DIST_BLAS.set(_DistBlas(mask))
    try:
        yield
    finally:
        _DIST_BLAS.reset(token)


def _masked(x, mask):
    from repro_torch.distributed.sharding import zero_shard_padding

    return zero_shard_padding(x, mask)


# =============================================================================
# Fused apply-with-reduction ops
# =============================================================================

spmv_dot_csr_op = registry.operation(
    "spmv_dot_csr", "(y, w·y) = (A @ x, fused dot) for CSR"
)
spmv_dot_ell_op = registry.operation(
    "spmv_dot_ell", "(y, w·y) = (A @ x, fused dot) for ELLPACK"
)
axpy_norm_op = registry.operation(
    "axpy_norm", "(z, z·z) with z = alpha*x + y, fused"
)


def _spmv_dot_csr(spmv):
    def fused(ex, A, x, w):
        y = spmv(ex, A, x)
        return y, torch.dot(w, y)
    return fused


def _spmv_dot_ell(ex, A, x, w):
    y = _spmv_ell_plain(ex, A, x)
    return y, torch.dot(w, y)


def _axpy_norm(ex, alpha, x, y):
    # 1-D vectors, or (nb, n) batches with one alpha and one z·z per row:
    # the batched solvers share this op with the single-system loops
    if x.ndim not in (1, 2):
        raise NotImplementedError("axpy_norm takes 1-D vectors or (nb, n) batches")
    return axpy_norm_plain(alpha, x, y)


spmv_dot_csr_op.register("reference")(_spmv_dot_csr(_spmv_csr_ref))
spmv_dot_csr_op.register("torch")(_spmv_dot_csr(_spmv_csr_torch))
for _space in ("reference", "torch"):
    spmv_dot_ell_op.register(_space)(_spmv_dot_ell)
    axpy_norm_op.register(_space)(_axpy_norm)

_FUSED_SPMV_OP = {Csr: spmv_dot_csr_op, Ell: spmv_dot_ell_op}


def _format_block(A):
    # a distributed solve's local operator names the format of its blocks
    return getattr(A, "format_block", A)


def has_fused_ops(A, *, executor=None) -> bool:
    """Capability probe: can this executor serve the fused iteration ops for
    ``A``?  False for formats/operators without a fused SpMV.  A distributed
    local operator answers for the format of its blocks."""
    from repro_torch.core.executor import current_executor

    op = _FUSED_SPMV_OP.get(type(_format_block(A)))
    if op is None:
        return False
    ex = executor if executor is not None else current_executor()
    return op.supports(ex) and axpy_norm_op.supports(ex)


def spmv_dot(A, x, w=None, *, executor=None):
    """Fused SpMV + dot: ``(y, w·y)`` with ``w`` defaulting to ``x``.

    Under the distributed context the dot is summed over the ranks.  A local
    operator that is one block with no halo and no padding keeps the fused
    op (one pass over the block); otherwise it is the local apply (halo
    exchange included), then the masked dot.
    """
    w = x if w is None else w
    ctx = _DIST_BLAS.get()
    if ctx is None:
        return _FUSED_SPMV_OP[type(A)](A, x, w, executor=executor)
    block = getattr(A, "fused_block", A)
    op = _FUSED_SPMV_OP.get(type(block))
    if ctx.mask is None and op is not None:
        y, local = op(block, x, w, executor=executor)
    else:
        y = apply(A, x, executor=executor)
        local = dot_op(_masked(w, ctx.mask), _masked(y, ctx.mask),
                       executor=executor)
    return y, ctx.sum(local)


def axpy_norm(alpha, x, y, *, executor=None):
    """Fused axpy + squared norm: ``(z, ‖z‖²)`` with ``z = alpha*x + y``;
    under the distributed context ‖z‖² is summed over the ranks (a padded
    shard takes the axpy, then the masked dot)."""
    ctx = _DIST_BLAS.get()
    if ctx is None:
        return axpy_norm_op(alpha, x, y, executor=executor)
    if ctx.mask is None:
        z, local = axpy_norm_op(alpha, x, y, executor=executor)
    else:
        z = axpy_op(alpha, x, y, executor=executor)
        zm = _masked(z, ctx.mask)
        local = dot_op(zm, zm, executor=executor)
    return z, ctx.sum(local)


# =============================================================================
# Sparse-sparse composition: SpGEMM and sparse transpose
# =============================================================================
#
# ``gko::Csr::apply(Csr)``, the setup-path workhorse behind AMG's Galerkin
# product R·A·P.  The structure of C = A·B depends on the data; the torch
# and cuda spaces run the same structure passes, on the operands' device,
# around their numeric passes:
#
#   1. row-nnz upper bound: expand each a_ik into the length of B's row k and
#      build the padded (T, K) gather map (T = nnz(A), K = the widest row of
#      B that A reaches), +1-shifted into B's values with slot 0 the zero pad;
#   2. numeric expansion: the (T, K) products a_ik·b_kj — the flop-carrying
#      pass (the torch space's plain gather-multiply, the cuda space's
#      ``spgemm_expand`` kernel);
#   3. coalesce: a stable sort of the valid products by (row, col) — the
#      order of the host lexsort — then the merge of each run of equal
#      coordinates (the torch space's ``np.add.reduceat`` on the host, the
#      cuda space's ``spgemm_merge`` kernel, which adds in numpy's order),
#      and indptr.
#
# Steps 1 and 3's structure are integer passes and step 2 is one multiply
# per entry, so both spaces give the JAX package's structure and values bit
# for bit (its host coalesce is the same lexsort and ``np.add.reduceat``);
# the reference space's per-row merge sums the same products in the same
# order.  Structural nonzeros are kept even when numerically zero: the
# pattern is a pure function of the operand patterns.  The transpose's
# structure pass (the column-major order of A's entries) is a host lexsort
# in the reference space and a stable device argsort of the (column, row)
# keys in the torch and cuda spaces; its numeric pass is the value shuffle
# ``values[order]`` (the cuda space's ``csr_permute``).

spgemm_op = registry.operation(
    "spgemm", "C = A @ B for CSR pairs (sparse-sparse composition)"
)
sptranspose_op = registry.operation(
    "sptranspose", "B = A^T for CSR (sorted column-major permutation)"
)


def _empty_csr(m: int, n: int, dtype: torch.dtype, device) -> Csr:
    return Csr(
        indptr=torch.zeros(m + 1, dtype=torch.int32, device=device),
        indices=torch.zeros(0, dtype=torch.int32, device=device),
        values=torch.zeros(0, dtype=dtype, device=device),
        shape=(int(m), int(n)),
    )


def _spgemm_expansion(A: Csr, B: Csr):
    """Step 1 on A's device: ``(rows_a, K, valid, idx1, cols)`` — the output
    row of each entry of A, the (T, K) validity mask, the +1-shifted int32
    gather map into the zero-padded values of B, and the output column of
    every slot (structure, so computed here from the same map)."""
    bi = B.indptr.long()
    ac = A.indices.long()
    rows_a = _csr_row_ids(A)
    b_start = bi[ac]
    b_len = (bi[1:] - bi[:-1])[ac]
    K = int(b_len.max()) if b_len.numel() else 0
    q = torch.arange(K, device=ac.device)
    valid = q[None, :] < b_len[:, None]
    idx1 = torch.where(valid, b_start[:, None] + q[None, :] + 1, 0).to(torch.int32)
    bc_pad = torch.cat([bi.new_zeros(1), B.indices.long()])
    return rows_a, K, valid, idx1, bc_pad[idx1]


def _coalesce_host(rows, cols, vals, m: int):
    """Sort (row, col, val) triplets, merge duplicate coordinates in their
    order, build CSR arrays — on the host (AMG's smoothed prolongator)."""
    if rows.size == 0:
        return (
            np.zeros(m + 1, np.int64),
            np.zeros(0, np.int32),
            np.zeros(0, vals.dtype),
        )
    order = np.lexsort((cols, rows))
    r, c, v = rows[order], cols[order], vals[order]
    head = np.ones(r.size, bool)
    head[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    starts = np.flatnonzero(head)
    out_v = np.add.reduceat(v, starts)
    out_r, out_c = r[starts], c[starts]
    indptr = np.zeros(m + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(out_r, minlength=m))
    return indptr, out_c.astype(np.int32), out_v


def _coalesce(rows, cols, vals, shape, *, merge) -> Csr:
    """Step 3 on the triplets' device: :func:`_coalesce_host`'s CSR, with
    ``merge(sorted_vals, starts)`` summing each run of equal coordinates."""
    m, n = shape
    key, order = torch.sort(rows * n + cols, stable=True)
    head = torch.ones_like(key, dtype=torch.bool)
    head[1:] = key[1:] != key[:-1]
    starts = torch.nonzero(head).flatten()
    out_v = merge(vals[order], starts)
    out_key = key[starts]
    del key, order, head
    counts = torch.bincount(out_key // n, minlength=m)
    indptr = torch.zeros(m + 1, dtype=torch.int32, device=rows.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return Csr(indptr=indptr, indices=(out_key % n).to(torch.int32),
               values=out_v, shape=(int(m), int(n)))


@spgemm_op.register("reference")
def _spgemm_ref(ex, A: Csr, B: Csr) -> Csr:
    """Oracle: sequential per-row merge (Ginkgo's reference kernel)."""
    m = A.shape[0]
    n = B.shape[1]
    ai = host_array(A.indptr).astype(np.int64)
    ac = host_array(A.indices)
    av = host_array(A.values)
    bi = host_array(B.indptr).astype(np.int64)
    bc = host_array(B.indices)
    bv = host_array(B.values)
    dtype = np.result_type(av.dtype, bv.dtype)
    indptr = np.zeros(m + 1, np.int64)
    out_cols: list = []
    out_vals: list = []
    for i in range(m):
        row_c: list = []
        row_v: list = []
        for t in range(int(ai[i]), int(ai[i + 1])):
            k = int(ac[t])
            s0, s1 = int(bi[k]), int(bi[k + 1])
            row_c.append(bc[s0:s1])
            row_v.append(av[t] * bv[s0:s1])
        if row_c:
            cat_c = np.concatenate(row_c)
            cat_v = np.concatenate(row_v)
            uniq, inv = np.unique(cat_c, return_inverse=True)
            acc = np.zeros(uniq.size, dtype)
            np.add.at(acc, inv, cat_v)
            out_cols.append(uniq.astype(np.int32))
            out_vals.append(acc)
            indptr[i + 1] = indptr[i] + uniq.size
        else:
            indptr[i + 1] = indptr[i]
    cols = np.concatenate(out_cols) if out_cols else np.zeros(0, np.int32)
    vals = np.concatenate(out_vals) if out_vals else np.zeros(0, dtype)
    return csr_from_arrays(indptr, cols, vals, (m, n), device=A.values.device)


def _spgemm_skeleton(ex, A: Csr, B: Csr, *, expand, merge) -> Csr:
    """The three steps on A's device: the structure pass,
    ``expand(a_vals, idx1, b_pad)`` for the products, the coalesce with
    ``merge``.  The torch space passes the plain gather-multiply and the
    host ``np.add.reduceat``, the cuda space the ``spgemm_expand`` and
    ``spgemm_merge`` kernels."""
    m = A.shape[0]
    n = B.shape[1]
    dev = A.values.device
    dtype = torch.promote_types(A.dtype, B.dtype)
    with span("spgemm.structure", cat="spgemm"):
        rows_a, K, valid, idx1, cols = _spgemm_expansion(A, B)
    if K == 0 or rows_a.numel() == 0:
        return _empty_csr(m, n, dtype, dev)
    with span("spgemm.numeric", cat="spgemm", t=int(rows_a.numel()), k=K):
        b_pad = torch.cat([torch.zeros(1, dtype=dtype, device=dev),
                           B.values.to(dtype)])
        prod = expand(A.values.to(dtype), idx1, b_pad)
    with span("spgemm.coalesce", cat="spgemm"):
        rows = rows_a[:, None].expand(-1, K)[valid]
        return _coalesce(rows, cols[valid], prod[valid], (m, n), merge=merge)


@spgemm_op.register("torch")
def _spgemm_torch(ex, A: Csr, B: Csr) -> Csr:
    """One-shot expansion: the padded gather-multiply as one torch op."""
    return _spgemm_skeleton(ex, A, B, expand=spgemm_expand_plain,
                            merge=spgemm_merge_plain)


def _transpose_structure(A: Csr):
    """Host structure pass of the transpose: ``(order, indptr, rows)`` — the
    column-major order of A's entries (host lexsort), the transposed indptr
    and the transposed column indices (A's row ids in that order)."""
    m, n = A.shape
    ai = host_array(A.indptr).astype(np.int64)
    cols = host_array(A.indices).astype(np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ai))
    order = np.lexsort((rows, cols))
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(cols, minlength=n))
    return order, indptr, rows[order]


def _transpose_structure_device(A: Csr):
    """:func:`_transpose_structure` on A's device: a stable argsort of the
    (column, row) keys orders A's entries as the host lexsort does."""
    m, n = A.shape
    rows = _csr_row_ids(A)
    cols = A.indices.long()
    order = torch.argsort(cols * m + rows, stable=True)
    counts = torch.bincount(cols, minlength=n)
    indptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return order, indptr, rows[order]


def _sptranspose_skeleton(ex, A: Csr, *, permute,
                          structure=_transpose_structure) -> Csr:
    """The structure pass, then ``permute(values, order)`` on A's device."""
    m, n = A.shape
    dev = A.values.device
    with span("sptranspose.structure", cat="spgemm"):
        order, indptr, t_cols = structure(A)
    with span("sptranspose.numeric", cat="spgemm", nnz=int(order.shape[0])):
        vals = permute(A.values,
                       torch.as_tensor(order, device=dev).to(torch.int32))
    return Csr(
        indptr=torch.as_tensor(indptr, device=dev).to(torch.int32),
        indices=torch.as_tensor(t_cols, device=dev).to(torch.int32),
        values=vals,
        shape=(n, m),
    )


@sptranspose_op.register("reference")
def _sptranspose_ref(ex, A: Csr) -> Csr:
    """Oracle: host lexsort of the swapped triplets, then the value gather."""
    return _sptranspose_skeleton(ex, A, permute=csr_permute_plain)


@sptranspose_op.register("torch")
def _sptranspose_torch(ex, A: Csr) -> Csr:
    """Device transpose: the device structure pass and the value gather."""
    return _sptranspose_skeleton(ex, A, permute=csr_permute_plain,
                                 structure=_transpose_structure_device)


def spgemm(A: Csr, B: Csr, *, executor=None) -> Csr:
    """``C = A @ B`` for CSR operands — executor-dispatched SpGEMM.

    Output rows are column-sorted and duplicate-free; structural nonzeros are
    kept even when numerically zero, so the result pattern is a pure function
    of the operand patterns.
    """
    if not isinstance(A, Csr) or not isinstance(B, Csr):
        raise TypeError(
            f"spgemm needs CSR operands, got {type(A).__name__} × "
            f"{type(B).__name__}"
        )
    m, k = A.shape
    k2, n = B.shape
    if k != k2:
        raise ValueError(f"spgemm shape mismatch: {A.shape} @ {B.shape}")
    if m == 0 or n == 0 or k == 0 or A.nnz == 0 or B.nnz == 0:
        return _empty_csr(m, n, torch.promote_types(A.dtype, B.dtype),
                          A.values.device)
    return spgemm_op(A, B, executor=executor)


def sptranspose(A: Csr, *, executor=None) -> Csr:
    """``B = Aᵀ`` for CSR — executor-dispatched sparse transpose."""
    if not isinstance(A, Csr):
        raise TypeError(f"sptranspose needs a CSR operand, got {type(A).__name__}")
    m, n = A.shape
    if m == 0 or n == 0 or A.nnz == 0:
        return _empty_csr(n, m, A.dtype, A.values.device)
    return sptranspose_op(A, executor=executor)


# the cuda kernels register their spaces on import
import repro_torch.kernels  # noqa: E402,F401
