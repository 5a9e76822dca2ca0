"""Conjugate gradient — the slice of the JAX package's Krylov set on the main path.

``cg`` runs every vector operation through executor-dispatched BLAS-1 / SpMV
ops (:mod:`repro_torch.sparse.ops`), so one source serves every executor.
The JAX package's ``lax.while_loop`` becomes a Python loop whose scalars
(``alpha``, ``beta``, ``rz``, ``rnorm``) stay 0-d tensors on the vectors'
device; the loop condition ``rnorm > threshold`` is the only value the host
reads per iteration.

``CgSolver(A, stop=...)`` is the factory-style twin: a LinOp whose apply
solves, so a solver can precondition another solver.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from repro_torch.core.linop import LinOp, as_linop
from repro_torch.observability import convergence
from repro_torch.solvers.common import (
    SolveResult,
    Stop,
    ensure_symmetric,
    identity_preconditioner,
)
from repro_torch.sparse import ops as blas

__all__ = ["cg", "CgSolver"]

#: a preconditioner: a LinOp / callable ``v -> M^{-1} v`` or a kind name
#: (``"identity"`` / ``"jacobi"`` / ``"block_jacobi"``) resolved against ``A``
#: by :func:`repro_torch.precond.make_preconditioner`
Precond = Union[LinOp, Callable, str]


def _resolve_precond(A, M, executor, precond_opts):
    if isinstance(M, str):
        from repro_torch.precond import make_preconditioner

        return make_preconditioner(A, M, executor=executor, **(precond_opts or {}))
    if precond_opts:
        raise ValueError("precond_opts is only meaningful when M is a kind name")
    return M if M is not None else identity_preconditioner


def _as_fn(M, executor):
    """Thread the solver's executor down a LinOp preconditioner: A and M must
    dispatch in the same kernel space (a bare callable has none to thread)."""
    if isinstance(M, LinOp):
        return lambda v: M.apply(v, executor=executor)
    return M


def _keep_going(k: int, stop: Stop, rnorm, thresh) -> bool:
    # k is a host int, so reaching max_iters costs no device read
    return k < stop.max_iters and bool(rnorm > thresh)


def cg(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    stop: Stop = Stop(),
    M: Optional[Precond] = None,
    precond_opts: Optional[dict] = None,
    executor=None,
    fused: Optional[bool] = None,
    pipeline: bool = False,
    history=None,
    strict: bool = True,
) -> SolveResult:
    """Preconditioned conjugate gradient (SPD systems).

    ``strict=True`` runs a seeded symmetry probe on format operands and
    raises on a nonsymmetric A.  ``history=True`` (or an int capacity)
    records per-iteration residual norms in a device ring buffer.

    ``fused`` selects the apply-with-reduction loop (SpMV + dot and axpy +
    norm each one launch).  ``None`` uses it when the executor serves the
    fused ops for A's format; ``False`` forces the unfused loop.  In the
    reference and torch spaces both loops give bitwise-equal results.

    ``pipeline=True`` (pipelined CG) is not ported yet and raises.
    """
    ensure_symmetric(A, solver="cg", strict=strict)
    if pipeline:
        raise NotImplementedError("pipelined CG is not ported to repro_torch yet")
    want_fused = True if fused is None else bool(fused)
    if want_fused and blas.has_fused_ops(A, executor=executor):
        return _cg_fused(A, b, x0, stop=stop, M=M, precond_opts=precond_opts,
                         executor=executor, history=history)
    ex = executor
    Aop = as_linop(A)
    x = torch.zeros_like(b) if x0 is None else x0
    Mfn = _as_fn(_resolve_precond(A, M, ex, precond_opts), ex)
    bnorm = blas.norm2(b, executor=ex)
    thresh = stop.threshold(bnorm)

    r = b - Aop.apply(x, executor=ex)
    z = Mfn(r)
    p = z
    rz = blas.dot(r, z, executor=ex)
    rnorm = blas.norm2(r, executor=ex)
    hist = convergence.init(convergence.capacity(history, stop),
                            dtype=rnorm.dtype, device=b.device)
    k = 0
    while _keep_going(k, stop, rnorm, thresh):
        Ap = Aop.apply(p, executor=ex)
        alpha = rz / blas.dot(p, Ap, executor=ex)
        x = blas.axpy(alpha, p, x, executor=ex)
        r = blas.axpy(-alpha, Ap, r, executor=ex)
        z = Mfn(r)
        rz_new = blas.dot(r, z, executor=ex)
        beta = rz_new / rz
        p = blas.axpy(beta, p, z, executor=ex)
        rnorm = blas.norm2(r, executor=ex)
        rz = rz_new
        convergence.push(hist, k, rnorm)
        k += 1
    return SolveResult(x, k, rnorm, bool(rnorm <= thresh),
                       convergence.finalize(hist))


def _cg_fused(A, b, x0, *, stop, M, precond_opts, executor, history=None):
    """CG on the fused-reduction ops: every iteration issues one ``spmv_dot``
    (Ap and p·Ap in one pass over A) and one ``axpy_norm`` (the r update and
    ‖r‖² in one pass).  With the identity preconditioner ``r·z`` is that
    ‖r‖², so the loop carries no standalone dot."""
    ex = executor
    Aop = as_linop(A)
    x = torch.zeros_like(b) if x0 is None else x0
    Mres = _resolve_precond(A, M, ex, precond_opts)
    identity_M = Mres is identity_preconditioner
    Mfn = _as_fn(Mres, ex)
    bnorm = blas.norm2(b, executor=ex)
    thresh = stop.threshold(bnorm)

    r = b - Aop.apply(x, executor=ex)
    z = Mfn(r)
    p = z
    rz = blas.dot(r, z, executor=ex)
    rnorm = blas.norm2(r, executor=ex)
    hist = convergence.init(convergence.capacity(history, stop),
                            dtype=rnorm.dtype, device=b.device)
    k = 0
    while _keep_going(k, stop, rnorm, thresh):
        Ap, pAp = blas.spmv_dot(A, p, executor=ex)
        alpha = rz / pAp
        x = blas.axpy(alpha, p, x, executor=ex)
        r, rr = blas.axpy_norm(-alpha, Ap, r, executor=ex)
        if identity_M:
            z, rz_new = r, rr
        else:
            z = Mfn(r)
            rz_new = blas.dot(r, z, executor=ex)
        beta = rz_new / rz
        p = blas.axpy(beta, p, z, executor=ex)
        rnorm = torch.sqrt(rr)
        rz = rz_new
        convergence.push(hist, k, rnorm)
        k += 1
    return SolveResult(x, k, rnorm, bool(rnorm <= thresh),
                       convergence.finalize(hist))


class CgSolver(LinOp):
    """A generated CG solver as a LinOp: ``apply(b)`` solves ``A x = b``.

    The symmetry probe and string preconditioners run at construction
    (Ginkgo's ``generate``); ``solve(b)`` returns the full
    :class:`SolveResult`, ``apply(b)`` only x.  ``options`` are passed to
    :func:`cg`.
    """

    def __init__(self, A, *, stop: Stop = Stop(), M: Optional[Precond] = None,
                 precond_opts: Optional[dict] = None, executor=None, **options):
        self.A = as_linop(A)
        self.stop = stop
        # probed once here; the solve-time probe is then skipped
        ensure_symmetric(A, solver="CgSolver", strict=options.get("strict", True))
        options["strict"] = False
        self.M = _resolve_precond(A, M, executor, precond_opts)
        self.executor = executor
        self.options = options

    @property
    def shape(self):
        return getattr(self.A, "shape", None)

    @property
    def dtype(self):
        return getattr(self.A, "dtype", None)

    def solve(self, b: torch.Tensor, x0=None, *, executor=None) -> SolveResult:
        ex = executor if executor is not None else self.executor
        return cg(self.A, b, x0, stop=self.stop, M=self.M, executor=ex,
                  **self.options)

    def _apply(self, b, executor):
        return self.solve(b, executor=executor).x
