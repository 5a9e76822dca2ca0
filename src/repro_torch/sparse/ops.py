"""Executor-dispatched sparse operations (SpMV per format) + BLAS-1.

* ``reference`` space — sequential-semantics formulations (scatter-add CSR);
* ``torch`` space     — portable torch formulations (the JAX package's XLA);
* ``cuda`` space      — registered by :mod:`repro_torch.kernels` for the ops
  that have a Pallas kernel in the JAX package: ``spmv_ell``,
  ``spmv_dot_ell``, ``axpy_norm`` (and ``block_jacobi_apply``).  The other ops
  here have no kernel there either, and a CUDA executor serves them from the
  torch space on CUDA tensors.

``apply(A, x)`` mirrors ``gko::LinOp::apply``: dispatch on the format, then on
the executor's kernel space.

Contract of the fused ops (as in the JAX package): in the reference and torch
spaces ``spmv_dot_*`` and ``axpy_norm`` are the literal unfused composition
(SpMV then ``dot``; ``axpy`` then ``dot``), so a solver's fused and unfused
paths give bitwise-equal results there.  The cuda kernels sum in another order
and agree within rounding.
"""

from __future__ import annotations

import torch

from repro_torch.core import registry
from repro_torch.kernels.axpy_norm.kernel import axpy_norm_plain
from repro_torch.kernels.spmv_ell.kernel import spmv_ell_plain
from repro_torch.sparse.formats import Csr, Dense, Ell, MatrixLinOp

__all__ = [
    "apply",
    "dot",
    "axpy",
    "scal",
    "norm2",
    "spmv_dot",
    "axpy_norm",
    "has_fused_ops",
]

# =============================================================================
# SpMV
# =============================================================================

spmv_csr = registry.operation("spmv_csr", "y = A @ x for CSR")
spmv_ell = registry.operation("spmv_ell", "y = A @ x for ELLPACK")
spmv_dense = registry.operation("spmv_dense", "y = A @ x (dense)")


def _csr_row_ids(A: Csr) -> torch.Tensor:
    counts = (A.indptr[1:] - A.indptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(A.shape[0], device=A.values.device), counts
    )


def _spmv_csr_plain(ex, A: Csr, x):
    y = torch.zeros((A.shape[0],) + tuple(x.shape[1:]),
                    dtype=torch.promote_types(A.values.dtype, x.dtype),
                    device=x.device)
    vals = A.values[:, None] if x.ndim == 2 else A.values
    return y.index_add_(0, _csr_row_ids(A), vals * x[A.indices])


spmv_csr.register("reference")(_spmv_csr_plain)
spmv_csr.register("torch")(_spmv_csr_plain)


def _spmv_ell_plain(ex, A: Ell, x):
    if x.ndim != 1:
        raise NotImplementedError("ELL spmv takes one right-hand side")
    return spmv_ell_plain(A.col_idx, A.values, x)


spmv_ell.register("reference")(_spmv_ell_plain)
spmv_ell.register("torch")(_spmv_ell_plain)


def _spmv_dense_plain(ex, A: Dense, x):
    return A.values @ x


spmv_dense.register("reference")(_spmv_dense_plain)
spmv_dense.register("torch")(_spmv_dense_plain)


_FORMAT_OP = {Csr: spmv_csr, Ell: spmv_ell, Dense: spmv_dense}


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
    return dot_op(x, y, executor=executor)


def axpy(alpha, x, y, *, executor=None):
    return axpy_op(alpha, x, y, executor=executor)


def scal(alpha, x, *, executor=None):
    return scal_op(alpha, x, executor=executor)


def norm2(x, *, executor=None):
    return norm2_op(x, executor=executor)


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


def _spmv_dot_csr(ex, A, x, w):
    y = _spmv_csr_plain(ex, A, x)
    return y, torch.dot(w, y)


def _spmv_dot_ell(ex, A, x, w):
    y = _spmv_ell_plain(ex, A, x)
    return y, torch.dot(w, y)


def _axpy_norm(ex, alpha, x, y):
    if x.ndim != 1:
        raise NotImplementedError("axpy_norm takes 1-D vectors")
    return axpy_norm_plain(alpha, x, y)


for _space in ("reference", "torch"):
    spmv_dot_csr_op.register(_space)(_spmv_dot_csr)
    spmv_dot_ell_op.register(_space)(_spmv_dot_ell)
    axpy_norm_op.register(_space)(_axpy_norm)

_FUSED_SPMV_OP = {Csr: spmv_dot_csr_op, Ell: spmv_dot_ell_op}


def has_fused_ops(A, *, executor=None) -> bool:
    """Capability probe: can this executor serve the fused iteration ops for
    ``A``?  False for formats/operators without a fused SpMV."""
    from repro_torch.core.executor import current_executor

    op = _FUSED_SPMV_OP.get(type(A))
    if op is None:
        return False
    ex = executor if executor is not None else current_executor()
    return op.supports(ex) and axpy_norm_op.supports(ex)


def spmv_dot(A, x, w=None, *, executor=None):
    """Fused SpMV + dot: ``(y, w·y)`` with ``w`` defaulting to ``x``."""
    w = x if w is None else w
    return _FUSED_SPMV_OP[type(A)](A, x, w, executor=executor)


def axpy_norm(alpha, x, y, *, executor=None):
    """Fused axpy + squared norm: ``(z, ‖z‖²)`` with ``z = alpha*x + y``."""
    return axpy_norm_op(alpha, x, y, executor=executor)


# the cuda kernels register their spaces on import
import repro_torch.kernels  # noqa: E402,F401
