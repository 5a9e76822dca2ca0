"""Plain preconditioned conjugate gradient, Ginkgo's ``solver::Cg`` with the
combined stop (``max_iters``, ``||r|| <= max(reduction_factor * ||b||,
abs_tol)``), from x0 = 0.  Every vector and scalar is in ``dtype``.
Independent of ``repro_torch``.

``keep_at=k`` also returns the iterate after k iterations (running past the
own stop if k is larger, up to ``max_iters``), so a solution can be compared
with the reference's at the same iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Result:
    x: torch.Tensor
    iterations: int
    residual_norm: float
    converged: bool
    x_kept: Optional[torch.Tensor] = None


def solve(apply_A, apply_M, b: torch.Tensor, stop: dict, *,
          dtype: torch.dtype, keep_at: Optional[int] = None) -> Result:
    b = b.to(dtype)
    thresh = max(float(torch.linalg.vector_norm(b.double()))
                 * float(stop.get("reduction_factor", 1e-6)),
                 float(stop.get("abs_tol", 0.0)))
    max_iters = int(stop["max_iters"])
    x = torch.zeros_like(b)
    r = b.clone()
    z = apply_M(r).to(dtype)
    p = z
    rz = torch.dot(r, z)
    rnorm = float(torch.linalg.vector_norm(r))
    k, own = 0, None
    kept = x if keep_at == 0 else None
    while k < max_iters:
        if own is None and rnorm <= thresh:
            own = (k, x, rnorm)
        if own is not None and (keep_at is None or k >= keep_at):
            break
        Ap = apply_A(p).to(dtype)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_M(r).to(dtype)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        rnorm = float(torch.linalg.vector_norm(r))
        k += 1
        if k == keep_at:
            kept = x
    if own is None:
        own = (k, x, rnorm)
    k_own, x_own, r_own = own
    return Result(x_own, k_own, r_own, r_own <= thresh, kept)
