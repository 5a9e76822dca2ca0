"""Implicit (deep-equilibrium) layers: a sparse solve as a differentiable op.

The forward pass is a generated :class:`~repro_torch.solvers.krylov.GmresSolver`
apply, ``x = A(values)^{-1} b`` for a CSR operand with a fixed sparsity
pattern and trainable ``values``.  The backward pass is the adjoint method:
for a loss ``L`` with incoming gradient ``g = dL/dx``,

    lambda        = A^{-T} g                       (one transposed solve)
    dL/d b        = lambda
    dL/d values_t = -lambda[row_t] * x[col_t]

The transposed system is solved through the
:class:`~repro_torch.core.linop.Transpose` combinator, on the forward pass's
executor, so forward and backward run in one kernel space.  The JAX
package's ``jax.custom_vjp`` is a ``torch.autograd.Function`` here; its
``jax.vmap`` over right-hand sides becomes one call a sample.

Differentiating through the unrolled iterations would be wrong (the iterate
is not the solution) and would keep every Arnoldi basis; the adjoint needs
only the converged ``x`` and one more solve of the forward's cost.  CSR has
no Pallas kernel in the JAX package, so this path launches no hand-written
kernel: its SpMVs are the torch space's segment sums.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.linop import Transpose
from repro_torch.solvers.common import Stop
from repro_torch.solvers.krylov import GmresSolver, gmres
from repro_torch.sparse.formats import Csr

__all__ = ["make_implicit_solve"]


class _Pattern:
    """The fixed CSR pattern, the solver settings, and the pattern's index
    tensors a device."""

    def __init__(self, indptr, indices, shape, restart, stop, bwd_stop,
                 executor):
        self.indptr = np.asarray(indptr, np.int64)
        self.indices = np.asarray(indices, np.int64)
        self.shape = tuple(int(s) for s in shape)
        self.restart = restart
        self.stop = stop
        self.bwd_stop = bwd_stop if bwd_stop is not None else stop
        self.executor = executor
        self._on = {}

    def tensors(self, device):
        """(indptr, indices, row and column of every entry) on ``device``."""
        key = str(device)
        if key not in self._on:
            rows = np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))
            self._on[key] = (
                torch.as_tensor(self.indptr.astype(np.int32), device=device),
                torch.as_tensor(self.indices.astype(np.int32), device=device),
                torch.as_tensor(rows, device=device),
                torch.as_tensor(self.indices, device=device),
            )
        return self._on[key]

    def operator(self, values: torch.Tensor) -> Csr:
        indptr, indices, _, _ = self.tensors(values.device)
        return Csr(indptr=indptr, indices=indices, values=values,
                   shape=self.shape)


class _ImplicitSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, b, pat: _Pattern):
        values, b = values.detach(), b.detach()
        x = GmresSolver(pat.operator(values), restart=pat.restart,
                        stop=pat.stop, executor=pat.executor).apply(b)
        ctx.save_for_backward(values, x)
        ctx.pat = pat
        return x

    @staticmethod
    def backward(ctx, g):
        values, x = ctx.saved_tensors
        pat = ctx.pat
        At = Transpose(pat.operator(values), executor=pat.executor)
        lam = gmres(At, g.contiguous(), restart=pat.restart,
                    stop=pat.bwd_stop, executor=pat.executor).x
        _, _, rows, cols = pat.tensors(values.device)
        bar_values = -lam[rows] * x[cols]
        return bar_values.to(values.dtype), lam.to(g.dtype), None


def make_implicit_solve(
    indptr,
    indices,
    shape,
    *,
    restart: int = 30,
    stop: Stop = Stop(max_iters=400, reduction_factor=1e-8),
    bwd_stop: Optional[Stop] = None,
    executor=None,
):
    """Build ``solve(values, b) -> x``, differentiable in both arguments.

    ``indptr`` / ``indices`` / ``shape`` fix the CSR pattern (host arrays);
    ``values`` and ``b`` are tensors on one device.  ``bwd_stop`` defaults
    to the forward ``stop``; loosening it trades gradient accuracy for
    backward time (the inexact-adjoint knob).
    """
    n_rows, n_cols = shape
    if n_rows != n_cols:
        raise ValueError(f"implicit solve needs a square operator, got {shape}")
    pat = _Pattern(indptr, indices, shape, restart, stop, bwd_stop, executor)

    def solve(values: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _ImplicitSolve.apply(values, b, pat)

    return solve
