"""Distributed Krylov solves — the solver source runs unchanged on every rank.

:func:`dist_solve` is what the solver entry points
(:mod:`repro_torch.solvers.krylov`) hand a distributed operator to.  Every
rank of the world calls it with the same global ``b``; it runs the ordinary
solver function on the rank's shard with

* the matrix's local operator (local SpMV + halo exchange,
  :meth:`~repro_torch.distributed.matrix.DistLinOp.local_operator`);
* a rank-local preconditioner (:mod:`repro_torch.distributed.precond`);
* the distributed BLAS context
  (:func:`repro_torch.sparse.ops.distributed_blas`), under which every
  reduction the solver issues is summed over the ranks in a fixed order,
  the padding masked.

The stopping test reads those sums, which every rank holds bit for bit, so
every rank takes the same branch and the world stays in step; the result is
the single-card :class:`SolveResult` with the global ``x`` on every rank.
The JAX package compiles each solve under ``jit``; the port runs eagerly and
keeps no cache.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed import comm
from repro_torch.distributed.precond import dist_preconditioner
from repro_torch.distributed.vector import check_world, local_mask
from repro_torch.solvers.common import SolveResult, Stop

__all__ = ["dist_solve"]


def dist_solve(
    solver_fn,
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    stop: Stop = Stop(),
    M=None,
    precond_opts: Optional[dict] = None,
    executor=None,
    **options,
) -> SolveResult:
    """Run ``solver_fn`` (cg / fcg / bicgstab / cgs / gmres) over ``A``'s
    partition, this process being rank ``A.rank``.  ``b`` / ``x0`` are
    global vectors (the same on every rank); the result's ``x`` is global."""
    from repro_torch.sparse import ops as sparse_ops

    part, rank = A.partition, A.rank
    if check_world(part) != rank:
        raise ValueError(f"this process is not rank {rank}, whose rows the "
                         "distributed operand holds")
    Md = dist_preconditioner(A, M, executor=executor, **(precond_opts or {}))
    b_l = part.pad_part(b, rank)
    x_l = part.pad_part(x0, rank) if x0 is not None else torch.zeros_like(b_l)
    Aop = A.local_operator(executor=executor)
    Ml = Md.local_operator(executor=executor) if Md is not None else None
    with sparse_ops.distributed_blas(local_mask(part, rank, b_l.device)):
        res = solver_fn(Aop, b_l, x_l, stop=stop, M=Ml, executor=executor,
                        **options)
    x = part.unpad_flat(comm.all_gather_shards(res.x, kind="gather"))
    return SolveResult(x, res.iterations, res.residual_norm, res.converged,
                       res.history)
