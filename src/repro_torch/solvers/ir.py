"""Iterative refinement / Richardson iteration — gko::solver::Ir.

The outer loop is the textbook refinement

    r_k = b - A x_k          (outer precision: b's dtype)
    d_k = S(r_k)             (inner solver: any LinOp approximating A⁻¹)
    x_{k+1} = x_k + d_k

The inner solver ``S`` may be a relaxation scalar (plain Richardson through
:class:`~repro_torch.core.linop.ScaledIdentity`), a preconditioner, or a
generated Krylov solver over a reduced-precision copy of A: mixed-precision
iterative refinement, whose inner CG streams f32 operator data while the
outer residual runs against the f64 operator.

The inner tolerance is budgeted from the inner dtype's unit roundoff
(:func:`repro_torch.precond.unit_roundoff`): solving the correction much
below ``sqrt(u_inner)`` buys nothing, the inner operator being accurate only
to ``u_inner``.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from repro_torch.core.linop import LinOp, ScaledIdentity, as_linop
from repro_torch.observability import convergence
from repro_torch.solvers.common import SolveResult, Stop
from repro_torch.solvers.krylov import CgSolver, _keep_going
from repro_torch.sparse import ops as blas

__all__ = ["ir", "mixed_precision_ir", "IrSolver"]


def ir(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    stop: Stop = Stop(),
    inner: Optional[Union[LinOp, Callable]] = None,
    inner_dtype=None,
    relaxation: float = 1.0,
    executor=None,
    history=None,
) -> SolveResult:
    """Iterative-refinement / Richardson outer loop.

    ``inner`` is any LinOp (or callable) approximating ``A⁻¹``;
    ``inner=None`` is plain Richardson ``x += relaxation * r``.
    ``inner_dtype`` casts the residual down before the inner apply and the
    correction back up after it.  The outer residual, norms and ``x`` stay
    in ``b``'s dtype; ``iterations`` counts outer sweeps.
    """
    Aop = as_linop(A)
    x = torch.zeros_like(b) if x0 is None else x0
    if inner is None:
        inner = ScaledIdentity(relaxation, b.shape[0], dtype=b.dtype)
    ex = executor
    bnorm = blas.norm2(b, executor=ex)
    thresh = stop.threshold(bnorm)

    def correction(r):
        r_in = r.to(inner_dtype) if inner_dtype is not None else r
        # the outer executor threads down the inner subtree (a bare callable
        # has none to thread)
        d = (inner.apply(r_in, executor=ex) if isinstance(inner, LinOp)
             else inner(r_in))
        return d.to(b.dtype)

    # the residual in the advanced-apply form A.apply(-1, x, 1, b): one
    # full-precision apply a sweep
    r = Aop.apply(-1.0, x, 1.0, b, executor=ex)
    rnorm = blas.norm2(r, executor=ex)
    hist = convergence.init(convergence.capacity(history, stop),
                            dtype=rnorm.dtype, device=b.device)
    k = 0
    while _keep_going(k, stop, rnorm, thresh):
        x = x + correction(r)
        r = Aop.apply(-1.0, x, 1.0, b, executor=ex)
        rnorm = blas.norm2(r, executor=ex)
        convergence.push(hist, k, rnorm)
        k += 1
    return SolveResult(x, k, rnorm, bool(rnorm <= thresh),
                       convergence.finalize(hist))


def mixed_precision_ir(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    stop: Stop = Stop(),
    inner_dtype=torch.float32,
    inner_solver: type = CgSolver,
    inner_stop: Optional[Stop] = None,
    inner_opts: Optional[dict] = None,
    executor=None,
    history=None,
) -> SolveResult:
    """Mixed-precision IR: a reduced-precision inner Krylov solve under a
    full-precision outer residual.

    The inner operator is ``A.astype(inner_dtype)`` (structure shared,
    values cast), solved by ``inner_solver`` (CG by default) to
    ``sqrt(unit_roundoff(inner_dtype))`` within 200 iterations unless
    ``inner_stop`` says otherwise.
    """
    from repro_torch.precond import unit_roundoff

    astype = getattr(A, "astype", None)
    if astype is None:
        raise TypeError(
            f"mixed_precision_ir needs an operator with astype() to build the "
            f"reduced-precision inner copy; {type(A).__name__} has none — "
            "pass an explicit inner solver to ir() instead"
        )
    A_low = astype(inner_dtype)
    if inner_stop is None:
        u_inner = unit_roundoff(inner_dtype)
        inner_stop = Stop(max_iters=200, reduction_factor=u_inner ** 0.5)
    inner = inner_solver(A_low, stop=inner_stop, executor=executor,
                         **(inner_opts or {}))
    return ir(A, b, x0, stop=stop, inner=inner, inner_dtype=inner_dtype,
              executor=executor, history=history)


class IrSolver(LinOp):
    """Generated IR solver as a LinOp (``inner=`` / ``relaxation=`` forward):
    ``IrSolver(A, inner=CgSolver(A.astype(torch.float32), ...))`` composes
    like any other operator."""

    def __init__(self, A, *, stop: Stop = Stop(), inner=None, inner_dtype=None,
                 relaxation: float = 1.0, executor=None, history=None):
        self.A = as_linop(A)
        self.stop = stop
        self.inner = inner
        self.inner_dtype = inner_dtype
        self.relaxation = relaxation
        self.executor = executor
        self.history = history

    @property
    def shape(self):
        return getattr(self.A, "shape", None)

    @property
    def dtype(self):
        return getattr(self.A, "dtype", None)

    def solve(self, b: torch.Tensor, x0=None, *, executor=None) -> SolveResult:
        ex = executor if executor is not None else self.executor
        return ir(self.A, b, x0, stop=self.stop, inner=self.inner,
                  inner_dtype=self.inner_dtype, relaxation=self.relaxation,
                  executor=ex, history=self.history)

    def _apply(self, b, executor):
        return self.solve(b, executor=executor).x
