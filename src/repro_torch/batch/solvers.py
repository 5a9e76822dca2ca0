"""Masked batched Krylov solvers — gko::batch::solver::{Cg, Bicgstab}.

Every sweep advances all systems at once; a per-system convergence mask
freezes the systems whose residual is already under their own threshold
(their state is carried through unchanged by ``where``), and the loop ends
when every system has converged or the sweep cap is reached.  Per-system
iteration counts therefore match a loop of single-system solves.

The JAX package's ``lax.while_loop`` becomes a Python loop: the state stays
on the device and the host reads one flag per sweep, ``any(rnorm >
thresh)``.  ``num_sweeps`` bounds a call of ``*_advance`` to that many
further sweeps, and a run advanced in chunks issues the same operations as
one advanced at once, so the two agree bit for bit.

Every vector operation goes through the executor-dispatched batched BLAS-1 /
SpMV operations (:mod:`repro_torch.batch.ops`), so one solver source serves
every kernel space.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from repro_torch.batch import ops
from repro_torch.batch.formats import BatchCsr, BatchEll
from repro_torch.batch.linop import BatchIdentity, BatchLinOp
from repro_torch.core import registry
from repro_torch.core.linop import LinOp
from repro_torch.observability import convergence
from repro_torch.solvers.common import Stop
from repro_torch.sparse.ops import _csr_row_ids

__all__ = [
    "BatchSolveResult",
    "BatchCgState",
    "BatchBicgstabState",
    "BatchScalarJacobi",
    "batch_extract_diag_op",
    "batch_cg",
    "batch_cg_init",
    "batch_cg_advance",
    "batch_bicgstab",
    "batch_bicgstab_init",
    "batch_bicgstab_advance",
    "batch_jacobi_preconditioner",
    "batch_block_jacobi_preconditioner",
    "batch_identity_preconditioner",
]

BatchMatrixLike = Union[BatchLinOp, Callable[[torch.Tensor], torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class BatchSolveResult:
    """Per-system outcome: ``x (nb, n)``, ``iterations (nb,) int32``,
    ``residual_norms (nb,)``, ``converged (nb,) bool``."""

    x: torch.Tensor
    iterations: torch.Tensor
    residual_norms: torch.Tensor
    converged: torch.Tensor
    #: ``(cap, nb)`` residual norms per sweep when the solve ran with
    #: ``history=`` (NaN in unfilled slots); None otherwise
    history: Optional[torch.Tensor] = None

    @property
    def num_batch(self) -> int:
        return self.x.shape[0]


def _apply(A, X: torch.Tensor, executor) -> torch.Tensor:
    if isinstance(A, BatchLinOp):
        return A.apply(X, executor=executor)
    if callable(A) and not hasattr(A, "values"):
        return A(X)
    return ops.apply_batch(A, X, executor=executor)


def _as_fn(M, executor):
    """Thread the solver's executor down a LinOp preconditioner, as the
    single-system solvers do (a bare callable has none to thread)."""
    M = M or batch_identity_preconditioner
    if isinstance(M, LinOp):
        return lambda V: M.apply(V, executor=executor)
    return M


def _setup(A, B, X0, M, executor=None, precond_opts=None):
    X = torch.zeros_like(B) if X0 is None else X0
    if isinstance(M, str):
        opts = dict(precond_opts or {})
        if M == "identity":
            if opts:
                raise ValueError(
                    f"identity preconditioner takes no options, got {sorted(opts)}"
                )
            M = batch_identity_preconditioner
        elif M == "jacobi":
            M = batch_jacobi_preconditioner(A, executor=executor, **opts)
        elif M == "block_jacobi":
            M = batch_block_jacobi_preconditioner(A, executor=executor, **opts)
        else:
            raise KeyError(
                f"unknown batched preconditioner kind {M!r}; known: "
                "identity, jacobi, block_jacobi"
            )
    elif precond_opts:
        raise ValueError("precond_opts is only meaningful when M is a kind name")
    return X, M or batch_identity_preconditioner


# =============================================================================
# Preconditioners
# =============================================================================

batch_extract_diag_op = registry.operation(
    "batch_extract_diagonal", "per-system diagonals of a batched matrix"
)


@batch_extract_diag_op.register("reference")
def _batch_extract_diag_ref(ex, A):
    n = min(A.shape)
    if isinstance(A, BatchCsr):
        rows = _csr_row_ids(A.system(0))
        hit = (rows == A.indices) & (rows < n)
        idx = torch.where(hit, rows, 0)
        return torch.stack([
            A.values.new_zeros(n).index_add_(0, idx,
                                             torch.where(hit, A.values[b], 0.0))
            for b in range(A.num_batch)])
    if isinstance(A, BatchEll):
        m = A.col_idx.shape[0]
        hit = A.col_idx == torch.arange(m, device=A.col_idx.device)[:, None]
        return torch.stack([torch.where(hit, A.values[b], 0.0).sum(dim=1)[:n]
                            for b in range(A.num_batch)])
    raise TypeError(f"unknown batched format {type(A)}")


@batch_extract_diag_op.register("torch")
def _batch_extract_diag_torch(ex, A):
    n = min(A.shape)
    if isinstance(A, BatchCsr):
        rows = _csr_row_ids(A.system(0))
        hit = (rows == A.indices) & (rows < n)
        contrib = torch.where(hit[None, :], A.values, 0.0)
        return A.values.new_zeros((A.num_batch, n)).index_add_(
            1, torch.where(hit, rows, 0), contrib)
    if isinstance(A, BatchEll):
        m = A.col_idx.shape[0]
        hit = A.col_idx == torch.arange(m, device=A.col_idx.device)[:, None]
        return torch.where(hit[None], A.values, 0.0).sum(dim=2)[:, :n]
    raise TypeError(f"unknown batched format {type(A)}")


class BatchScalarJacobi(BatchLinOp):
    """Per-system scalar Jacobi: ``M^{-1} V[b] = inv_diag[b] * V[b]``."""

    def __init__(self, inv_diag: torch.Tensor):
        self.inv_diag = inv_diag  # (nb, n)

    @property
    def shape(self):
        n = self.inv_diag.shape[1]
        return (n, n)

    @property
    def num_batch(self) -> int:
        return self.inv_diag.shape[0]

    @property
    def dtype(self):
        return self.inv_diag.dtype

    @property
    def storage_bytes(self) -> int:
        return self.inv_diag.numel() * self.inv_diag.element_size()

    def _apply(self, V, executor):
        return self.inv_diag.to(V.dtype) * V


def batch_jacobi_preconditioner(A, executor=None) -> BatchScalarJacobi:
    """Per-system scalar Jacobi, ``M^{-1} V[b] = V[b] / diag(A[b])`` (a zero
    diagonal entry gives 1)."""
    d = batch_extract_diag_op(A, executor=executor)
    nz = d.abs() > 0
    inv = torch.where(nz, 1.0 / torch.where(nz, d, torch.ones_like(d)),
                      torch.ones_like(d))
    return BatchScalarJacobi(inv)


def batch_block_jacobi_preconditioner(A, block_size: Optional[int] = None, *,
                                      adaptive=False, tau: Optional[float] = None,
                                      executor=None):
    """Per-system block-Jacobi — :func:`repro_torch.precond.batch_block_jacobi`
    (shared slot table, per-system blocks inverted in one batch, applied by
    the ``block_jacobi_apply`` kernel)."""
    from repro_torch.precond import batch_block_jacobi

    return batch_block_jacobi(
        A, block_size, adaptive=adaptive, executor=executor,
        **({} if tau is None else {"tau": tau}),
    )


#: the batched identity preconditioner (``storage_bytes == 0``)
batch_identity_preconditioner = BatchIdentity()


# =============================================================================
# Batched CG
# =============================================================================


@dataclasses.dataclass(frozen=True)
class BatchCgState:
    """Full in-flight state of a masked batched CG run, so a caller can
    advance it in chunks."""

    X: torch.Tensor      # (nb, n) iterates
    R: torch.Tensor      # (nb, n) residuals
    Z: torch.Tensor      # (nb, n) preconditioned residuals
    P: torch.Tensor      # (nb, n) search directions
    rz: torch.Tensor     # (nb,)  <R, Z>
    iters: torch.Tensor  # (nb,)  per-system iteration counts
    k: int               # global sweep counter
    rnorm: torch.Tensor  # (nb,)  per-system residual norms
    hist: torch.Tensor   # (cap, nb) residual history rows


def _empty_result(B, stop: Stop, history) -> BatchSolveResult:
    """nb == 0: nothing to launch."""
    stop.threshold(B.new_zeros(0))  # still reject degenerate stops
    hist = convergence.init(convergence.capacity(history, stop), batch=0,
                            dtype=B.dtype, device=B.device)
    return BatchSolveResult(B, torch.zeros(0, dtype=torch.int32, device=B.device),
                            B.new_zeros(0),
                            torch.zeros(0, dtype=torch.bool, device=B.device),
                            convergence.finalize(hist))


def _keep_going(rnorm, thresh, k: int, k0: int, stop: Stop,
                num_sweeps: Optional[int]) -> bool:
    # host ints first: reaching a cap costs no device read
    if k >= stop.max_iters or (num_sweeps is not None and k - k0 >= num_sweeps):
        return False
    return bool((rnorm > thresh).any())


def batch_cg_init(A, B, X, *, M=None, executor=None,
                  history_cap: int = 0) -> BatchCgState:
    """Initial CG state for iterate ``X``: residual, first search direction,
    per-system norms."""
    ex = executor
    Mfn = _as_fn(M, ex)
    R = B - _apply(A, X, ex)
    Z = Mfn(R)
    P = Z
    rz = ops.batch_dot(R, Z, executor=ex)
    rnorm = ops.batch_norm2(R, executor=ex)
    iters = torch.zeros(B.shape[0], dtype=torch.int32, device=B.device)
    hist = convergence.init(history_cap, batch=B.shape[0], dtype=rnorm.dtype,
                            device=B.device)
    return BatchCgState(X, R, Z, P, rz, iters, 0, rnorm, hist)


def batch_cg_advance(A, state: BatchCgState, thresh, *, stop: Stop = Stop(),
                     M=None, num_sweeps: Optional[int] = None,
                     executor=None) -> BatchCgState:
    """Advance the masked CG loop from ``state`` until every system has
    ``rnorm <= thresh`` or the sweep counter reaches ``stop.max_iters`` —
    or, with ``num_sweeps``, for at most that many more sweeps."""
    ex = executor
    Mfn = _as_fn(M, ex)
    X, R, Z, P = state.X, state.R, state.Z, state.P
    rz, iters, k, rnorm, hist = (state.rz, state.iters, state.k, state.rnorm,
                                 state.hist)
    k0 = k
    while _keep_going(rnorm, thresh, k, k0, stop, num_sweeps):
        active = rnorm > thresh  # (nb,)
        a2 = active[:, None]
        AP = _apply(A, P, ex)
        pAp = ops.batch_dot(P, AP, executor=ex)
        # the guards matter only for frozen systems, whose update is dropped
        alpha = rz / torch.where(pAp == 0, torch.ones_like(pAp), pAp)
        Xn = ops.batch_axpy(alpha, P, X, executor=ex)
        # the residual update and the mask's per-system ‖R‖² in one pass
        Rn, rr = ops.batch_axpy_norm(-alpha, AP, R, executor=ex)
        Zn = Mfn(Rn)
        rz_new = ops.batch_dot(Rn, Zn, executor=ex)
        beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
        Pn = ops.batch_axpy(beta, P, Zn, executor=ex)
        X = torch.where(a2, Xn, X)
        R = torch.where(a2, Rn, R)
        Z = torch.where(a2, Zn, Z)
        P = torch.where(a2, Pn, P)
        rz = torch.where(active, rz_new, rz)
        rnorm = torch.where(active, torch.sqrt(rr), rnorm)
        iters = iters + active.to(torch.int32)
        # frozen systems keep recording their final norm: row k is the
        # batch's state after k + 1 sweeps
        convergence.push(hist, k, rnorm)
        k += 1
    return BatchCgState(X, R, Z, P, rz, iters, k, rnorm, hist)


def batch_cg(A, B, X0=None, *, stop: Stop = Stop(), M=None,
             precond_opts: Optional[dict] = None, executor=None,
             history=None) -> BatchSolveResult:
    """Batched preconditioned CG (SPD systems) with per-system stopping.

    ``B`` is ``(nb, n)``, one right-hand side per system.  An empty batch
    returns at once without a launch.
    """
    ex = executor
    if B.shape[0] == 0:
        return _empty_result(B, stop, history)
    X, M = _setup(A, B, X0, M, ex, precond_opts)
    thresh = stop.threshold(ops.batch_norm2(B, executor=ex))  # (nb,)
    state = batch_cg_init(A, B, X, M=M, executor=ex,
                          history_cap=convergence.capacity(history, stop))
    state = batch_cg_advance(A, state, thresh, stop=stop, M=M, executor=ex)
    return BatchSolveResult(state.X, state.iters, state.rnorm,
                            state.rnorm <= thresh,
                            convergence.finalize(state.hist))


# =============================================================================
# Batched BiCGSTAB
# =============================================================================


@dataclasses.dataclass(frozen=True)
class BatchBicgstabState:
    """In-flight state of a masked batched BiCGSTAB run; the shadow residual
    ``R_hat`` is carried so a caller can reseed one row."""

    X: torch.Tensor       # (nb, n) iterates
    R: torch.Tensor       # (nb, n) residuals
    R_hat: torch.Tensor   # (nb, n) shadow residuals
    P: torch.Tensor       # (nb, n) search directions
    rho: torch.Tensor     # (nb,)  <R_hat, R>
    iters: torch.Tensor   # (nb,)  per-system iteration counts
    k: int                # global sweep counter
    rnorm: torch.Tensor   # (nb,)  per-system residual norms
    hist: torch.Tensor    # (cap, nb) residual history rows


def batch_bicgstab_init(A, B, X, *, executor=None,
                        history_cap: int = 0) -> BatchBicgstabState:
    """Initial BiCGSTAB state for iterate ``X``."""
    ex = executor
    R = B - _apply(A, X, ex)
    R_hat = R
    rho = ops.batch_dot(R_hat, R, executor=ex)
    rnorm = ops.batch_norm2(R, executor=ex)
    iters = torch.zeros(B.shape[0], dtype=torch.int32, device=B.device)
    hist = convergence.init(history_cap, batch=B.shape[0], dtype=rnorm.dtype,
                            device=B.device)
    return BatchBicgstabState(X, R, R_hat, R, rho, iters, 0, rnorm, hist)


def batch_bicgstab_advance(A, state: BatchBicgstabState, thresh, *,
                           stop: Stop = Stop(), M=None,
                           num_sweeps: Optional[int] = None,
                           executor=None) -> BatchBicgstabState:
    """Advance the masked BiCGSTAB loop from ``state`` (the chunking contract
    of :func:`batch_cg_advance`)."""
    ex = executor
    Mfn = _as_fn(M, ex)
    eps = torch.tensor(1e-30, dtype=state.R.dtype, device=state.R.device)
    X, R, R_hat, P = state.X, state.R, state.R_hat, state.P
    rho, iters, k, rnorm, hist = (state.rho, state.iters, state.k, state.rnorm,
                                  state.hist)
    k0 = k
    while _keep_going(rnorm, thresh, k, k0, stop, num_sweeps):
        active = rnorm > thresh
        a2 = active[:, None]
        P_hat = Mfn(P)
        V = _apply(A, P_hat, ex)
        alpha = rho / (ops.batch_dot(R_hat, V, executor=ex) + eps)
        S = ops.batch_axpy(-alpha, V, R, executor=ex)
        S_hat = Mfn(S)
        T = _apply(A, S_hat, ex)
        omega = ops.batch_dot(T, S, executor=ex) / (
            ops.batch_dot(T, T, executor=ex) + eps)
        Xn = X + alpha[:, None] * P_hat + omega[:, None] * S_hat
        # the residual update and its per-system ‖R‖² in one pass
        Rn, rr = ops.batch_axpy_norm(-omega, T, S, executor=ex)
        rho_new = ops.batch_dot(R_hat, Rn, executor=ex)
        beta = (rho_new / (rho + eps)) * (alpha / (omega + eps))
        Pn = Rn + beta[:, None] * (P - omega[:, None] * V)
        X = torch.where(a2, Xn, X)
        R = torch.where(a2, Rn, R)
        P = torch.where(a2, Pn, P)
        rho = torch.where(active, rho_new, rho)
        rnorm = torch.where(active, torch.sqrt(rr), rnorm)
        iters = iters + active.to(torch.int32)
        convergence.push(hist, k, rnorm)
        k += 1
    return BatchBicgstabState(X, R, R_hat, P, rho, iters, k, rnorm, hist)


def batch_bicgstab(A, B, X0=None, *, stop: Stop = Stop(), M=None,
                   precond_opts: Optional[dict] = None, executor=None,
                   history=None) -> BatchSolveResult:
    """Batched preconditioned BiCGSTAB (general systems) with per-system
    stopping; an empty batch returns at once without a launch."""
    ex = executor
    if B.shape[0] == 0:
        return _empty_result(B, stop, history)
    X, M = _setup(A, B, X0, M, ex, precond_opts)
    thresh = stop.threshold(ops.batch_norm2(B, executor=ex))
    state = batch_bicgstab_init(A, B, X, executor=ex,
                                history_cap=convergence.capacity(history, stop))
    state = batch_bicgstab_advance(A, state, thresh, stop=stop, M=M,
                                   executor=ex)
    return BatchSolveResult(state.X, state.iters, state.rnorm,
                            state.rnorm <= thresh,
                            convergence.finalize(state.hist))
