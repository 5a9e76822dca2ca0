"""Executor-dispatched batched operations: SpMV per batched format + BLAS-1.

The single-system ops' three-space contract (:mod:`repro_torch.sparse.ops`):

* ``reference`` — a Python loop over the systems (Ginkgo's reference kernels
  iterate the batch);
* ``torch``     — one vectorised formulation over the whole batch;
* ``cuda``      — ``spmv_batch_ell``, registered by
  :mod:`repro_torch.kernels.spmv_batch_ell`, and the row-batched form of
  ``axpy_norm``.  The other ops have no kernel in the JAX package either, and
  a CUDA executor serves them from the torch space on CUDA tensors.

Batched vectors are ``(nb, n)``; batched scalars are ``(nb,)``.  CSR rows are
summed with ``index_add_``, which on a CUDA tensor adds with atomics in no
fixed order: a ``BatchCsr`` product there may differ run to run in the last
bits.  ``BatchEll`` has no such sum.
"""

from __future__ import annotations

import torch

from repro_torch.batch.formats import BatchCsr, BatchEll
from repro_torch.core import registry
from repro_torch.kernels.spmv_batch_ell.kernel import spmv_batch_ell_plain
from repro_torch.sparse.ops import _csr_row_ids, axpy_norm_op

__all__ = [
    "apply_batch",
    "batch_dot",
    "batch_axpy",
    "batch_axpy_norm",
    "batch_scal",
    "batch_norm2",
]

# =============================================================================
# Batched SpMV
# =============================================================================

spmv_batch_csr = registry.operation(
    "spmv_batch_csr", "Y[b] = A[b] @ X[b] for shared-pattern batched CSR"
)
spmv_batch_ell = registry.operation(
    "spmv_batch_ell", "Y[b] = A[b] @ X[b] for shared-pattern batched ELL"
)


def _out(A, X) -> torch.Tensor:
    return torch.zeros((X.shape[0], A.shape[0]),
                       dtype=torch.promote_types(A.dtype, X.dtype),
                       device=X.device)


@spmv_batch_csr.register("reference")
def _spmv_batch_csr_ref(ex, A: BatchCsr, X):
    rows = _csr_row_ids(A.system(0))
    out = _out(A, X)
    for b in range(A.num_batch):
        out[b].index_add_(0, rows, A.values[b] * X[b, A.indices])
    return out


@spmv_batch_csr.register("torch")
def _spmv_batch_csr_torch(ex, A: BatchCsr, X):
    rows = _csr_row_ids(A.system(0))
    return _out(A, X).index_add_(1, rows, A.values * X[:, A.indices])


@spmv_batch_ell.register("reference")
def _spmv_batch_ell_ref(ex, A: BatchEll, X):
    out = _out(A, X)
    for b in range(A.num_batch):
        out[b] = (A.values[b] * X[b][A.col_idx]).sum(dim=1)
    return out


@spmv_batch_ell.register("torch")
def _spmv_batch_ell_torch(ex, A: BatchEll, X):
    return spmv_batch_ell_plain(A.col_idx, A.values, X)


# =============================================================================
# Batched BLAS-1 (row-wise over the batch axis)
# =============================================================================

batch_dot_op = registry.operation("batch_blas_dot")
batch_axpy_op = registry.operation("batch_blas_axpy")
batch_scal_op = registry.operation("batch_blas_scal")
batch_norm2_op = registry.operation("batch_blas_norm2")


@batch_dot_op.register("reference")
def _batch_dot_ref(ex, X, Y):
    return torch.stack([torch.dot(X[b], Y[b]) for b in range(X.shape[0])])


@batch_dot_op.register("torch")
def _batch_dot_torch(ex, X, Y):
    return (X * Y).sum(dim=1)


@batch_axpy_op.register("reference")
def _batch_axpy_ref(ex, alpha, X, Y):
    return torch.stack([alpha[b] * X[b] + Y[b] for b in range(X.shape[0])])


@batch_axpy_op.register("torch")
def _batch_axpy_torch(ex, alpha, X, Y):
    return alpha[:, None] * X + Y


@batch_scal_op.register("reference")
def _batch_scal_ref(ex, alpha, X):
    return torch.stack([alpha[b] * X[b] for b in range(X.shape[0])])


@batch_scal_op.register("torch")
def _batch_scal_torch(ex, alpha, X):
    return alpha[:, None] * X


@batch_norm2_op.register("reference")
def _batch_norm2_ref(ex, X):
    return torch.stack([torch.sqrt(torch.dot(X[b], X[b]))
                        for b in range(X.shape[0])])


@batch_norm2_op.register("torch")
def _batch_norm2_torch(ex, X):
    return torch.sqrt((X * X).sum(dim=1))


# =============================================================================
# apply_batch — gko::batch::BatchLinOp::apply
# =============================================================================

_BATCH_FORMAT_OP = {BatchCsr: spmv_batch_csr, BatchEll: spmv_batch_ell}


def apply_batch(A, X: torch.Tensor, *, executor=None) -> torch.Tensor:
    """``Y[b] = A[b] @ X[b]``: format dispatch, then executor dispatch.

    Composed batched operators use their own ``apply``.
    """
    op = _BATCH_FORMAT_OP.get(type(A))
    if op is None:
        from repro_torch.batch.formats import BatchMatrixLinOp
        from repro_torch.batch.linop import BatchLinOp

        if isinstance(A, BatchLinOp) and not isinstance(A, BatchMatrixLinOp):
            return A.apply(X, executor=executor)
        raise TypeError(f"no batched spmv registered for format {type(A)}")
    return op(A, X, executor=executor)


def batch_dot(X, Y, *, executor=None):
    return batch_dot_op(X, Y, executor=executor)


def batch_axpy(alpha, X, Y, *, executor=None):
    return batch_axpy_op(alpha, X, Y, executor=executor)


def batch_scal(alpha, X, *, executor=None):
    return batch_scal_op(alpha, X, executor=executor)


def batch_norm2(X, *, executor=None):
    return batch_norm2_op(X, executor=executor)


def batch_axpy_norm(alpha, X, Y, *, executor=None):
    """Fused ``(Z, ‖Z[b]‖²)`` with ``Z = alpha[:, None] * X + Y``: the same
    ``axpy_norm`` operation the single-vector loops use (its cuda space
    launches the row-batched kernel on ``(nb, n)`` operands)."""
    return axpy_norm_op(alpha, X, Y, executor=executor)
