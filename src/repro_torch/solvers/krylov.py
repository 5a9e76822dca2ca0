"""Krylov solvers: CG (classic, fused, pipelined), FCG, BiCGSTAB, CGS and
GMRES(m) — the JAX package's solver set.

Every vector operation goes through executor-dispatched BLAS-1 / SpMV ops
(:mod:`repro_torch.sparse.ops`), so one source serves every executor.  The
JAX package's ``lax.while_loop`` becomes a Python loop whose scalars stay
0-d tensors on the vectors' device; the stopping test (``rnorm >
threshold``) is the only value the host reads an iteration (a restart cycle
for GMRES).

Each function has a factory-style LinOp twin (``CgSolver``, ``GmresSolver``,
...): ``CgSolver(A, stop=...)`` is a LinOp whose apply solves, so a solver
can precondition another solver or be the inner solve of iterative
refinement (:mod:`repro_torch.solvers.ir`).

A distributed operand (``is_distributed``) hands the whole solve to
:func:`repro_torch.distributed.dist_solve`, which re-enters the same
function on the rank's local operator, so the delegation happens once.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from repro_torch.core.linop import LinOp, as_linop
from repro_torch.observability import convergence
from repro_torch.observability import trace as _trace
from repro_torch.solvers.common import (
    SolveResult,
    Stop,
    ensure_symmetric,
    identity_preconditioner,
)
from repro_torch.sparse import ops as blas

__all__ = [
    "cg",
    "fcg",
    "bicgstab",
    "cgs",
    "gmres",
    "KrylovSolver",
    "CgSolver",
    "FcgSolver",
    "BicgstabSolver",
    "CgsSolver",
    "GmresSolver",
    "PipelinedCgSolver",
]

#: a preconditioner: a LinOp / callable ``v -> M^{-1} v`` or a kind name
#: (``"identity"`` / ``"jacobi"`` / ``"block_jacobi"`` / ``"parilu"`` /
#: ``"amg"``) resolved against ``A`` by
#: :func:`repro_torch.precond.make_preconditioner`
Precond = Union[LinOp, Callable, str]


def _dist_route(solver_fn, A, b, x0, *, stop, M, precond_opts, executor,
                **options):
    """Delegate to the distributed solve when ``A`` is a distributed
    operator (it re-enters ``solver_fn`` with the rank's local operator)."""
    from repro_torch.distributed.solvers import dist_solve

    return dist_solve(solver_fn, A, b, x0, stop=stop, M=M,
                      precond_opts=precond_opts, executor=executor, **options)


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


def _setup(A, b, x0, M, executor, precond_opts):
    """``(op, x, Mfn)``: A's apply and M's on the solver's executor, and the
    start vector."""
    Aop = as_linop(A)
    x = torch.zeros_like(b) if x0 is None else x0
    Mfn = _as_fn(_resolve_precond(A, M, executor, precond_opts), executor)
    return (lambda v: Aop.apply(v, executor=executor)), x, Mfn


def _keep_going(k: int, stop: Stop, rnorm, thresh) -> bool:
    # k is a host int, so reaching max_iters costs no device read
    return k < stop.max_iters and bool(rnorm > thresh)


def _stop_test(k: int, stop: Stop, rnorm, thresh) -> bool:
    """:func:`_keep_going` in a ``cg.stop_test`` span: the CG loops'
    blocking read of the residual norm."""
    with _trace.span("cg.stop_test"):
        return _keep_going(k, stop, rnorm, thresh)


def _precond(Mfn, r):
    """``Mfn(r)`` in a ``precond.apply`` span, timed on r's device while it
    records."""
    with _trace.span("precond.apply", device_of=r):
        return Mfn(r)


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

    ``pipeline=True`` runs the pipelined (Ghysels–Vanroose) variant: the
    three recurrence dots of an iteration are one ``dot_batch``.  It
    reassociates the recurrences, so its iteration count may differ from
    classic CG's by a step or two.
    """
    if getattr(A, "is_distributed", False):
        # no probe on the rank: a row block of a symmetric matrix is not
        # itself symmetric
        return _dist_route(cg, A, b, x0, stop=stop, M=M,
                           precond_opts=precond_opts, executor=executor,
                           fused=fused, pipeline=pipeline, history=history,
                           strict=False)
    ensure_symmetric(A, solver="cg", strict=strict)
    if pipeline:
        return _pipelined_cg(A, b, x0, stop=stop, M=M,
                             precond_opts=precond_opts, executor=executor,
                             history=history)
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
    z = _precond(Mfn, r)
    p = z
    rz = blas.dot(r, z, executor=ex)
    rnorm = blas.norm2(r, executor=ex)
    hist = convergence.init(convergence.capacity(history, stop),
                            dtype=rnorm.dtype, device=b.device)
    k = 0
    while _stop_test(k, stop, rnorm, thresh):
        Ap = Aop.apply(p, executor=ex)
        alpha = rz / blas.dot(p, Ap, executor=ex)
        x = blas.axpy(alpha, p, x, executor=ex)
        r = blas.axpy(-alpha, Ap, r, executor=ex)
        z = _precond(Mfn, r)
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
    z = _precond(Mfn, r)
    p = z
    rz = blas.dot(r, z, executor=ex)
    rnorm = blas.norm2(r, executor=ex)
    hist = convergence.init(convergence.capacity(history, stop),
                            dtype=rnorm.dtype, device=b.device)
    k = 0
    while _stop_test(k, stop, rnorm, thresh):
        Ap, pAp = blas.spmv_dot(A, p, executor=ex)
        alpha = rz / pAp
        x = blas.axpy(alpha, p, x, executor=ex)
        r, rr = blas.axpy_norm(-alpha, Ap, r, executor=ex)
        if identity_M:
            z, rz_new = r, rr
        else:
            z = _precond(Mfn, r)
            rz_new = blas.dot(r, z, executor=ex)
        beta = rz_new / rz
        p = blas.axpy(beta, p, z, executor=ex)
        rnorm = torch.sqrt(rr)
        rz = rz_new
        convergence.push(hist, k, rnorm)
        k += 1
    return SolveResult(x, k, rnorm, bool(rnorm <= thresh),
                       convergence.finalize(hist))


def _pipelined_cg(A, b, x0, *, stop, M, precond_opts, executor, history=None):
    """Pipelined (Ghysels–Vanroose) preconditioned CG: one batched reduction
    an iteration.

    The recurrences carry ``u = M r``, ``w = A u`` and ``z/q/s/p`` so that
    γ = r·u, δ = w·u and ‖r‖² all come from the same state: one
    :func:`repro_torch.sparse.ops.dot_batch` an iteration.  Before the loop
    it applies A twice (``A x``, ``A u``) and M once; each iteration applies
    M and A once, then 8 axpys and the batched dots, in the JAX package's
    order.
    """
    op, x, Mfn = _setup(A, b, x0, M, executor, precond_opts)
    ex = executor
    bnorm = blas.norm2(b, executor=ex)
    thresh = stop.threshold(bnorm)

    r = b - op(x)
    u = Mfn(r)
    w = op(u)
    gam, delta, rr = blas.dot_batch([(r, u), (w, u), (r, r)], executor=ex)
    z = q = s = p = torch.zeros_like(b)
    gam_old = alpha_old = torch.ones((), dtype=b.dtype, device=b.device)
    beta = torch.zeros((), dtype=gam.dtype, device=b.device)
    rnorm = torch.sqrt(rr)
    hist = convergence.init(convergence.capacity(history, stop),
                            dtype=rnorm.dtype, device=b.device)
    k = 0
    while _keep_going(k, stop, rnorm, thresh):
        if k > 0:
            beta = gam / gam_old
        # at k == 0 beta is 0, so the denominator reduces to delta
        alpha = gam / (delta - beta * gam / alpha_old)
        mv = Mfn(w)
        nv = op(mv)
        z = blas.axpy(beta, z, nv, executor=ex)
        q = blas.axpy(beta, q, mv, executor=ex)
        s = blas.axpy(beta, s, w, executor=ex)
        p = blas.axpy(beta, p, u, executor=ex)
        x = blas.axpy(alpha, p, x, executor=ex)
        r = blas.axpy(-alpha, s, r, executor=ex)
        u = blas.axpy(-alpha, q, u, executor=ex)
        w = blas.axpy(-alpha, z, w, executor=ex)
        gam_old, alpha_old = gam, alpha
        gam, delta, rr = blas.dot_batch([(r, u), (w, u), (r, r)], executor=ex)
        rnorm = torch.sqrt(rr)
        convergence.push(hist, k, rnorm)
        k += 1
    return SolveResult(x, k, rnorm, bool(rnorm <= thresh),
                       convergence.finalize(hist))


def fcg(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    stop: Stop = Stop(),
    M: Optional[Precond] = None,
    precond_opts: Optional[dict] = None,
    executor=None,
    history=None,
    strict: bool = True,
) -> SolveResult:
    """Flexible CG (Ginkgo's FCG): the Polak–Ribière beta
    ``z·(r - r_prev) / rz_prev``, robust to a preconditioner that changes
    between applies.  ``strict`` probes for symmetry as :func:`cg` does."""
    if getattr(A, "is_distributed", False):
        return _dist_route(fcg, A, b, x0, stop=stop, M=M,
                           precond_opts=precond_opts, executor=executor,
                           history=history, strict=False)
    ensure_symmetric(A, solver="fcg", strict=strict)
    op, x, Mfn = _setup(A, b, x0, M, executor, precond_opts)
    ex = executor
    bnorm = blas.norm2(b, executor=ex)
    thresh = stop.threshold(bnorm)

    r = b - op(x)
    z = Mfn(r)
    p = z
    rz = blas.dot(r, z, executor=ex)
    rnorm = blas.norm2(r, executor=ex)
    hist = convergence.init(convergence.capacity(history, stop),
                            dtype=rnorm.dtype, device=b.device)
    k = 0
    while _keep_going(k, stop, rnorm, thresh):
        Ap = op(p)
        alpha = rz / blas.dot(p, Ap, executor=ex)
        x = blas.axpy(alpha, p, x, executor=ex)
        r_new = blas.axpy(-alpha, Ap, r, executor=ex)
        z = Mfn(r_new)
        # the flexible beta takes the difference with the previous residual
        rz_new = blas.dot(r_new, z, executor=ex)
        beta = blas.dot(z, r_new - r, executor=ex) / rz
        p = blas.axpy(beta, p, z, executor=ex)
        rnorm = blas.norm2(r_new, executor=ex)
        r, rz = r_new, rz_new
        convergence.push(hist, k, rnorm)
        k += 1
    return SolveResult(x, k, rnorm, bool(rnorm <= thresh),
                       convergence.finalize(hist))


def _eps(b: torch.Tensor) -> torch.Tensor:
    """The breakdown guard the nonsymmetric solvers add to denominators."""
    return torch.tensor(1e-30, dtype=b.dtype, device=b.device)


def bicgstab(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    stop: Stop = Stop(),
    M: Optional[Precond] = None,
    precond_opts: Optional[dict] = None,
    executor=None,
    fused: Optional[bool] = None,
    history=None,
) -> SolveResult:
    """Preconditioned BiCGSTAB (general nonsymmetric systems).

    ``fused`` works as in :func:`cg`: ``None`` uses the fused
    apply-with-reduction loop when the executor serves it for A's format.
    In the reference and torch spaces both loops give bitwise-equal results
    for real dtypes.
    """
    if getattr(A, "is_distributed", False):
        return _dist_route(bicgstab, A, b, x0, stop=stop, M=M,
                           precond_opts=precond_opts, executor=executor,
                           fused=fused, history=history)
    want_fused = True if fused is None else bool(fused)
    if want_fused and blas.has_fused_ops(A, executor=executor):
        return _bicgstab_fused(A, b, x0, stop=stop, M=M,
                               precond_opts=precond_opts, executor=executor,
                               history=history)
    op, x, Mfn = _setup(A, b, x0, M, executor, precond_opts)
    ex = executor
    bnorm = blas.norm2(b, executor=ex)
    thresh = stop.threshold(bnorm)
    eps = _eps(b)

    r = b - op(x)
    r_hat = r
    rho = blas.dot(r_hat, r, executor=ex)
    p = r
    rnorm = blas.norm2(r, executor=ex)
    hist = convergence.init(convergence.capacity(history, stop),
                            dtype=rnorm.dtype, device=b.device)
    k = 0
    while _keep_going(k, stop, rnorm, thresh):
        p_hat = Mfn(p)
        v = op(p_hat)
        alpha = rho / (blas.dot(r_hat, v, executor=ex) + eps)
        s = blas.axpy(-alpha, v, r, executor=ex)
        s_hat = Mfn(s)
        t = op(s_hat)
        omega = blas.dot(t, s, executor=ex) / (blas.dot(t, t, executor=ex) + eps)
        x = x + alpha * p_hat + omega * s_hat
        r_new = blas.axpy(-omega, t, s, executor=ex)
        rho_new = blas.dot(r_hat, r_new, executor=ex)
        beta = (rho_new / (rho + eps)) * (alpha / (omega + eps))
        p = r_new + beta * (p - omega * v)
        rnorm = blas.norm2(r_new, executor=ex)
        r, rho = r_new, rho_new
        convergence.push(hist, k, rnorm)
        k += 1
    return SolveResult(x, k, rnorm, bool(rnorm <= thresh),
                       convergence.finalize(hist))


def _bicgstab_fused(A, b, x0, *, stop, M, precond_opts, executor,
                    history=None):
    """BiCGSTAB on the fused ops: both SpMVs carry their follow-up dot
    (``r̂·v`` and ``s·t``) and the last residual update carries ‖r‖², so five
    reductions an iteration become three launches (``t·t`` and ``r̂·r`` stay
    standalone).  For real dtypes ``s·t`` equals the unfused loop's ``t·s``
    bit for bit in the reference and torch spaces."""
    op, x, Mfn = _setup(A, b, x0, M, executor, precond_opts)
    ex = executor
    bnorm = blas.norm2(b, executor=ex)
    thresh = stop.threshold(bnorm)
    eps = _eps(b)

    r = b - op(x)
    r_hat = r
    rho = blas.dot(r_hat, r, executor=ex)
    p = r
    rnorm = blas.norm2(r, executor=ex)
    hist = convergence.init(convergence.capacity(history, stop),
                            dtype=rnorm.dtype, device=b.device)
    k = 0
    while _keep_going(k, stop, rnorm, thresh):
        p_hat = Mfn(p)
        v, rhv = blas.spmv_dot(A, p_hat, w=r_hat, executor=ex)
        alpha = rho / (rhv + eps)
        s = blas.axpy(-alpha, v, r, executor=ex)
        s_hat = Mfn(s)
        t, ts = blas.spmv_dot(A, s_hat, w=s, executor=ex)
        omega = ts / (blas.dot(t, t, executor=ex) + eps)
        x = x + alpha * p_hat + omega * s_hat
        r_new, rr = blas.axpy_norm(-omega, t, s, executor=ex)
        rho_new = blas.dot(r_hat, r_new, executor=ex)
        beta = (rho_new / (rho + eps)) * (alpha / (omega + eps))
        p = r_new + beta * (p - omega * v)
        rnorm = torch.sqrt(rr)
        r, rho = r_new, rho_new
        convergence.push(hist, k, rnorm)
        k += 1
    return SolveResult(x, k, rnorm, bool(rnorm <= thresh),
                       convergence.finalize(hist))


def cgs(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    stop: Stop = Stop(),
    M: Optional[Precond] = None,
    precond_opts: Optional[dict] = None,
    executor=None,
    history=None,
) -> SolveResult:
    """Conjugate Gradient Squared (Sonneveld): the solver set's
    transpose-free nonsymmetric method."""
    if getattr(A, "is_distributed", False):
        return _dist_route(cgs, A, b, x0, stop=stop, M=M,
                           precond_opts=precond_opts, executor=executor,
                           history=history)
    op, x, Mfn = _setup(A, b, x0, M, executor, precond_opts)
    ex = executor
    bnorm = blas.norm2(b, executor=ex)
    thresh = stop.threshold(bnorm)
    eps = _eps(b)

    r = b - op(x)
    r_hat = r
    rho = blas.dot(r_hat, r, executor=ex)
    u = r
    p = r
    rnorm = blas.norm2(r, executor=ex)
    hist = convergence.init(convergence.capacity(history, stop),
                            dtype=rnorm.dtype, device=b.device)
    k = 0
    while _keep_going(k, stop, rnorm, thresh):
        p_hat = Mfn(p)
        v = op(p_hat)
        alpha = rho / (blas.dot(r_hat, v, executor=ex) + eps)
        q = u - alpha * v
        uq_hat = Mfn(u + q)
        x = x + alpha * uq_hat
        r = r - alpha * op(uq_hat)
        rho_new = blas.dot(r_hat, r, executor=ex)
        beta = rho_new / (rho + eps)
        u = r + beta * q
        p = u + beta * (q + beta * p)
        rnorm = blas.norm2(r, executor=ex)
        rho = rho_new
        convergence.push(hist, k, rnorm)
        k += 1
    return SolveResult(x, k, rnorm, bool(rnorm <= thresh),
                       convergence.finalize(hist))


def gmres(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    restart: int = 30,
    stop: Stop = Stop(),
    M: Optional[Precond] = None,
    precond_opts: Optional[dict] = None,
    executor=None,
    history=None,
) -> SolveResult:
    """Restarted GMRES(m): modified Gram–Schmidt Arnoldi, Givens rotations,
    right preconditioning (A M⁻¹ u = b, x = M⁻¹ u, so the true residual
    needs no extra apply).

    A cycle runs all m Arnoldi steps and ``iterations`` counts m a cycle,
    as in the JAX package.  Step j's Gram–Schmidt runs the j + 1 live dots
    against V's rows 0..j; the JAX package runs all m + 1 with the rows
    past j masked to 0, which are zero, so the values are the same.  The
    Givens rotations so far are kept as their product Q (the JAX package
    applies them one by one to each new column): the new column is rotated
    by one product with Q, the step's rotation updates two rows of Q, and
    the rotated right-hand side is ``beta`` times Q's first column.  V
    (m + 1 × n), H and Q stay on the vectors' device.  ``history`` records
    the true residual once a cycle (slot ``k // m``).
    """
    if getattr(A, "is_distributed", False):
        return _dist_route(gmres, A, b, x0, stop=stop, M=M,
                           precond_opts=precond_opts, executor=executor,
                           restart=restart, history=history)
    op, x, Mfn = _setup(A, b, x0, M, executor, precond_opts)
    ex = executor
    n = b.shape[0]
    m = int(restart)
    dtype, dev = b.dtype, b.device
    bnorm = blas.norm2(b, executor=ex)
    thresh = stop.threshold(bnorm)
    eps = _eps(b)
    eye = torch.eye(m + 1, dtype=dtype, device=dev)

    def cycle(x):
        r = b - op(x)
        beta = blas.norm2(r, executor=ex)
        V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        V[0] = r / (beta + eps)
        H = torch.zeros((m, m), dtype=dtype, device=dev)  # the rotated triangle
        Q = eye.clone()  # the product of the rotations so far
        for j in range(m):
            w = op(Mfn(V[j]))
            h = []
            for i in range(j + 1):  # modified Gram-Schmidt
                hij = blas.dot(V[i], w, executor=ex)
                w = w - hij * V[i]
                h.append(hij)
            hj1 = blas.norm2(w, executor=ex)
            V[j + 1] = w / (hj1 + eps)
            # the earlier rotations, then the new one, which zeroes h[j + 1]
            col = Q[:j + 1, :j + 1] @ torch.stack(h)
            hj = col[j]
            denom = torch.sqrt(hj ** 2 + hj1 ** 2) + eps
            c, s = hj / denom, hj1 / denom
            H[:j + 1, j] = torch.cat((col[:j], (c * hj + s * hj1)[None]))
            rot = torch.stack((torch.stack((c, s)), torch.stack((-s, c))))
            Q[j:j + 2, :j + 2] = rot @ Q[j:j + 2, :j + 2]
        g = beta * Q[:m, 0]
        # back-substitution on the m x m triangle H y = g (each pivot + eps)
        y = torch.linalg.solve_triangular(H + eps * eye[:m, :m], g[:, None],
                                          upper=True)[:, 0]
        x_new = x + Mfn(V[:m].T @ y)
        return x_new, blas.norm2(b - op(x_new), executor=ex)

    rnorm = blas.norm2(b - op(x), executor=ex)
    hist = convergence.init(convergence.capacity(history, stop),
                            dtype=rnorm.dtype, device=dev)
    k = 0
    while _keep_going(k, stop, rnorm, thresh):
        x, rnorm = cycle(x)
        convergence.push(hist, k // m, rnorm)
        k += m
    return SolveResult(x, k, rnorm, bool(rnorm <= thresh),
                       convergence.finalize(hist))


# =============================================================================
# Factory-style solver LinOps — gko::solver::Cg::Factory ... ::generate(A)
# =============================================================================


class KrylovSolver(LinOp):
    """A generated solver as a LinOp: ``apply(b)`` solves ``A x = b``.

    String preconditioners resolve, and the CG family's symmetry probe runs,
    at construction (Ginkgo's ``generate``); ``solve(b)`` returns the full
    :class:`SolveResult`, ``apply(b)`` only x.  ``options`` are passed to
    the solver function.
    """

    _fn: Callable = None  # bound per subclass
    _requires_spd: bool = False  # the CG family probes at generation

    def __init__(self, A, *, stop: Stop = Stop(), M: Optional[Precond] = None,
                 precond_opts: Optional[dict] = None, executor=None,
                 **options):
        self.A = as_linop(A)
        self.stop = stop
        if self._requires_spd:
            # probed once here; the solve-time probe is then skipped
            ensure_symmetric(A, solver=type(self).__name__,
                             strict=options.get("strict", True))
            options["strict"] = False
        if getattr(self.A, "is_distributed", False):
            # a distributed operand generates through the rank-local
            # generators (a global M cannot apply on one rank's rows)
            from repro_torch.distributed.precond import dist_preconditioner

            self.M = dist_preconditioner(self.A, M, executor=executor,
                                         **(precond_opts or {}))
        else:
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
        with _trace.span("solve", solve=_trace.next_solve_index()):
            return type(self)._fn(self.A, b, x0, stop=self.stop, M=self.M,
                                  executor=ex, **self.options)

    def _apply(self, b, executor):
        return self.solve(b, executor=executor).x


class CgSolver(KrylovSolver):
    """Generated CG solver (SPD) as a LinOp."""

    _fn = staticmethod(cg)
    _requires_spd = True


class PipelinedCgSolver(KrylovSolver):
    """Generated pipelined CG solver: :class:`CgSolver` with
    ``pipeline=True`` in its options (one batched reduction an iteration)."""

    _fn = staticmethod(cg)
    _requires_spd = True

    def __init__(self, A, **kw):
        super().__init__(A, pipeline=True, **kw)


class FcgSolver(KrylovSolver):
    """Generated flexible-CG solver as a LinOp."""

    _fn = staticmethod(fcg)
    _requires_spd = True


class BicgstabSolver(KrylovSolver):
    """Generated BiCGSTAB solver as a LinOp."""

    _fn = staticmethod(bicgstab)


class CgsSolver(KrylovSolver):
    """Generated CGS solver as a LinOp."""

    _fn = staticmethod(cgs)


class GmresSolver(KrylovSolver):
    """Generated GMRES(m) solver as a LinOp (``restart=`` forwards)."""

    _fn = staticmethod(gmres)

    def __init__(self, A, *, restart: int = 30, **kw):
        super().__init__(A, restart=restart, **kw)
