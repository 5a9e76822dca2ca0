"""Shared solver machinery: results, stopping criteria, scalar preconditioners,
the symmetry guard.

Solvers are written against executor-dispatched BLAS-1/SpMV operations only,
so one solver source serves every executor.  Scalars of the iteration stay
0-d tensors on the vectors' device.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core.linop import Identity, LinOp, as_linop
from repro_torch.sparse.formats import Coo, Csr, Dense, Ell, Sellp, csr_host_arrays

__all__ = [
    "LinearOperator",
    "SolveResult",
    "Stop",
    "ScalarJacobi",
    "probe_symmetry",
    "ensure_symmetric",
    "jacobi_preconditioner",
    "block_jacobi_preconditioner",
    "identity_preconditioner",
]


class LinearOperator(LinOp):
    """Deprecated back-compat shim — use the operand directly, or
    :func:`repro_torch.core.linop.as_linop`.

    Formats, preconditioners and solver factories are LinOps themselves;
    wrapping one adds nothing.  The class delegates to ``as_linop`` so call
    sites written against the JAX package's shim keep its behaviour (a
    format applies through its registry-dispatched SpMV, a callable as a
    matrix-free operator).
    """

    def __init__(self, A, executor=None):
        warnings.warn(
            "repro_torch.solvers.common.LinearOperator is deprecated: formats, "
            "preconditioners and solvers are LinOps — pass them directly "
            "(or use repro_torch.core.linop.as_linop for bare callables)",
            DeprecationWarning,
            stacklevel=2,
        )
        self.A = A
        self.op = as_linop(A)
        self.executor = executor

    @property
    def shape(self):
        return getattr(self.op, "shape", None)

    @property
    def dtype(self):
        return getattr(self.op, "dtype", None)

    def _apply(self, x: torch.Tensor, executor) -> torch.Tensor:
        ex = executor if executor is not None else self.executor
        return self.op.apply(x, executor=ex)


@dataclasses.dataclass(frozen=True)
class SolveResult:
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor  # 0-d, on the solve's device
    converged: bool
    #: residual-norm ring buffer when the solve ran with ``history=``
    #: (see :mod:`repro_torch.observability.convergence`); None otherwise
    history: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class Stop:
    """Combined stopping criterion (gko::stop::Combined).

    Converged when ||r|| <= max(reduction_factor * ||b||, abs_tol), or stopped
    when iterations reach max_iters.
    """

    max_iters: int = 1000
    reduction_factor: float = 1e-6
    abs_tol: float = 0.0

    def threshold(self, bnorm: torch.Tensor) -> torch.Tensor:
        if self.reduction_factor == 0.0 and self.abs_tol == 0.0:
            raise ValueError(
                "degenerate stopping criterion: reduction_factor=0.0 with "
                "abs_tol=0.0 can never be satisfied; set abs_tol > 0 for "
                "absolute-tolerance-only stopping or reduction_factor > 0 "
                "for relative stopping"
            )
        return torch.clamp(bnorm * self.reduction_factor, min=self.abs_tol)


# -- preconditioners -----------------------------------------------------------

extract_diag_op = registry.operation("extract_diagonal")


def _diag_of_entries(A, rows, cols, n: int) -> torch.Tensor:
    """Sum of the entries with row == col < n, by row (COO, CSR, SELL-P)."""
    hit = (rows == cols) & (rows < n)
    return torch.zeros(n, dtype=A.values.dtype, device=A.values.device
                       ).index_add_(0, torch.where(hit, rows, 0),
                                    torch.where(hit, A.values, 0.0))


@extract_diag_op.register("reference")
def _extract_diag(ex, A):
    if isinstance(A, Dense):
        return torch.diagonal(A.values).clone()
    n = min(A.shape)
    if isinstance(A, Csr):
        counts = (A.indptr[1:] - A.indptr[:-1]).long()
        rows = torch.repeat_interleave(
            torch.arange(A.shape[0], device=A.values.device), counts)
        return _diag_of_entries(A, rows, A.indices, n)
    if isinstance(A, Coo):
        return _diag_of_entries(A, A.row_idx.long(), A.col_idx, n)
    if isinstance(A, Sellp):
        # read from the slice layout (the JAX package densifies, n² entries)
        from repro_torch.sparse.ops import sellp_rows

        return _diag_of_entries(A, sellp_rows(A), A.col_idx, n)
    if isinstance(A, Ell):
        m = A.values.shape[0]
        rows = torch.arange(m, device=A.values.device)[:, None]
        hit = A.col_idx == rows
        return torch.where(hit, A.values, 0.0).sum(dim=1)[:n]
    raise TypeError(f"cannot extract a diagonal from {type(A)}")


extract_diag_op.register("torch")(_extract_diag)


class ScalarJacobi(LinOp):
    """Scalar Jacobi LinOp: ``M^{-1} v = inv_diag * v`` (storage may be a
    reduced precision; the apply up-casts to the vector's dtype)."""

    def __init__(self, inv_diag: torch.Tensor):
        self.inv_diag = inv_diag

    @property
    def shape(self):
        n = self.inv_diag.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.inv_diag.dtype

    @property
    def storage_bytes(self) -> int:
        return self.inv_diag.numel() * self.inv_diag.element_size()

    def _apply(self, v, executor):
        return self.inv_diag.to(v.dtype) * v


def jacobi_preconditioner(A, executor=None, *,
                          adaptive: Union[bool, str, torch.dtype] = False
                          ) -> ScalarJacobi:
    """Scalar Jacobi: M^{-1} v = v / diag(A) (gko::preconditioner::Jacobi, bs=1).

    ``adaptive=True`` stores the inverse diagonal in fp16 when its range fits,
    else bf16; a dtype (or its name) forces that storage.
    """
    d = extract_diag_op(A, executor=executor)
    nz = d.abs() > 0
    inv = torch.where(nz, 1.0 / torch.where(nz, d, torch.ones_like(d)),
                      torch.ones_like(d))
    if adaptive is True:
        maxabs = float(inv.abs().max()) if inv.numel() else 0.0
        inv = inv.to(torch.float16 if maxabs < 65504.0 else torch.bfloat16)
    elif adaptive:
        inv = inv.to(getattr(torch, adaptive) if isinstance(adaptive, str)
                     else adaptive)
    return ScalarJacobi(inv)


def block_jacobi_preconditioner(A, block_size: Optional[int] = None,
                                executor=None, *, blocks=None,
                                adaptive: Union[bool, str, torch.dtype] = False,
                                tau: Optional[float] = None):
    """Block-Jacobi (gko::preconditioner::Jacobi with block size > 1):
    M^{-1} = blockdiag(A_11^{-1}, A_22^{-1}, ...).

    Delegates to :func:`repro_torch.precond.block_jacobi`: host-side block
    discovery (``blocks`` pins explicit pointers, e.g. from
    :func:`repro_torch.precond.natural_blocks`), extraction, batched
    Gauss-Jordan inversion and the executor-dispatched apply.
    ``block_size=None`` takes the executor's subgroup width from the
    hardware table; ``adaptive`` selects per-block storage precision.  The
    result is callable and reports ``storage_bytes`` / ``precision_counts``.
    """
    from repro_torch.precond import block_jacobi

    return block_jacobi(A, block_size, blocks=blocks, adaptive=adaptive,
                        executor=executor,
                        **({} if tau is None else {"tau": tau}))


#: the identity preconditioner — a LinOp with ``storage_bytes == 0``
identity_preconditioner = Identity()


# -- the symmetry guard --------------------------------------------------------


def probe_symmetry(A, *, seed: int = 0, rtol: float = 1e-4) -> Optional[bool]:
    """Seeded two-vector symmetry probe: is ``u^T A v == v^T A u``?

    ``True``/``False`` for square real format operands, ``None`` when the
    question cannot be answered cheaply (matrix-free operators, non-square or
    complex operands).  Runs in host numpy, so it leaves no trace in any
    executor's dispatch log.  The tolerance is relative to ``|u|^T |A| |v|``.
    """
    values = getattr(A, "values", None)
    shape = getattr(A, "shape", None)
    if values is None or shape is None or shape[0] != shape[1]:
        return None
    if not isinstance(values, torch.Tensor) or values.is_complex():
        return None
    try:
        indptr, indices, vals = csr_host_arrays(A)
    except TypeError:
        return None
    n = shape[0]
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(n)
    v = rng.standard_normal(n)
    vals = np.asarray(vals, dtype=np.float64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    cols = np.asarray(indices, dtype=np.int64)
    uAv = float(np.sum(u[rows] * vals * v[cols]))
    vAu = float(np.sum(v[rows] * vals * u[cols]))
    scale = float(np.sum(np.abs(u[rows]) * np.abs(vals) * np.abs(v[cols])))
    return abs(uAv - vAu) <= rtol * max(scale, 1.0)


def ensure_symmetric(A, *, solver: str, strict: bool = True, seed: int = 0) -> None:
    """Raise when an SPD-only solver receives an operator the probe finds
    nonsymmetric; ``strict=False`` skips the probe."""
    if not strict:
        return
    if probe_symmetry(A, seed=seed) is False:
        raise ValueError(
            f"{solver} requires a symmetric (SPD) operator, but a seeded "
            "symmetry probe found u^T A v != v^T A u. CG-family iterations "
            "silently produce garbage on nonsymmetric systems - use gmres, "
            "bicgstab, or cgs instead, or pass strict=False if the operator "
            "is symmetric in exact arithmetic."
        )
