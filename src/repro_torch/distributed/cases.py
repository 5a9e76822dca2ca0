"""Rank bodies: run a list of distributed cases on every rank of a world.

:func:`run_cases` is the function :func:`repro_torch.distributed.comm.run_world`
spawns to check the distributed layer against a reference: every rank
builds the same operators from the same host arrays, runs each case and
returns its results as numpy arrays and numbers, which the caller holds
against the single-card results (or the JAX package's).  It lives in the
package because a spawned rank imports its function by module and name.

A case is a dict with ``op`` one of

* ``"spmv"`` — ``fmt`` (``csr`` / ``ell``), ``host`` (indptr, indices,
  values), ``sizes`` (part sizes), ``x``: ``{"y"}`` the global ``A x``;
* ``"blas"`` — ``sizes``, ``x``, ``y``, ``poison`` (a value written into
  the padding slots first, or None): ``{"dot", "norm", "x", "axpy",
  "scal", "axis_size"}`` (``x``, ``2 x + y``, ``-3 x`` gathered);
* ``"solve"`` — ``solver`` (``cg`` / ``fcg`` / ``bicgstab`` / ``cgs`` /
  ``gmres``), ``fmt``, ``host``, ``sizes``, ``b``, ``stop`` (max_iters,
  reduction_factor), optional ``M``, ``precond_opts``, ``options``,
  ``repeat``: ``{"x", "iterations", "residual_norm", "converged",
  "history", "collectives", "repeat_equal"}``;
* ``"precond"`` — ``kind``, ``fmt``, ``host``, ``sizes``, ``v``,
  ``precond_opts``: ``{"y"}`` the global ``M^-1 v``;
* ``"shard_batch"`` — ``nb``, ``n``, ``fmt``: this rank's rows of
  :func:`repro_torch.launch.batch_solve.build_batch` and their solve.

``dtype`` on a case casts the values and vectors; ``device`` / ``executor``
of :func:`run_cases` place every case (the CPU and the torch space unless
asked).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

__all__ = ["run_cases"]


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _matrix(case, device):
    from repro_torch.distributed import DistCsr, DistEll, Partition

    ip, ix, v = case["host"]
    v = np.asarray(v, case.get("dtype", np.asarray(v).dtype))
    part = Partition.from_part_sizes(case["sizes"])
    cls = {"csr": DistCsr, "ell": DistEll}[case["fmt"]]
    return cls.from_host(ip, ix, v, part, device=device)


def _vec(a, case, device) -> torch.Tensor:
    a = np.asarray(a, case.get("dtype", np.asarray(a).dtype))
    return torch.as_tensor(a, device=device)


def _solve(case, ex, device) -> dict:
    from repro_torch.distributed import comm
    from repro_torch.solvers import krylov
    from repro_torch.solvers.common import Stop

    Ad = _matrix(case, device)
    b = _vec(case["b"], case, device)
    fn = getattr(krylov, case["solver"])
    stop = Stop(*case["stop"])
    kw = dict(stop=stop, M=case.get("M"), precond_opts=case.get("precond_opts"),
              executor=ex, **case.get("options", {}))
    comm.reset_collective_counts()
    res = fn(Ad, b, **kw)
    counts = comm.collective_counts()
    out = {"x": _np(res.x), "iterations": int(res.iterations),
           "residual_norm": float(res.residual_norm),
           "converged": bool(res.converged), "collectives": counts,
           "history": None if res.history is None else _np(res.history)}
    if case.get("repeat"):
        again = fn(Ad, b, **kw)
        out["repeat_equal"] = (again.iterations == res.iterations
                               and bool(torch.equal(again.x, res.x)))
    return out


def _blas(case, ex, device) -> dict:
    from repro_torch.distributed import (DistVector, Partition, dist_axpy,
                                         dist_dot, dist_norm2, dist_scal)
    from repro_torch.distributed.sharding import axis_size

    part = Partition.from_part_sizes(case["sizes"])
    xv = DistVector.from_global(_vec(case["x"], case, device), part)
    yv = DistVector.from_global(_vec(case["y"], case, device), part)
    if case.get("poison") is not None:
        mask = xv.mask
        if mask is not None:
            fill = torch.full_like(xv.local, case["poison"])
            xv = DistVector(torch.where(mask, xv.local, fill), part, xv.rank)
            yv = DistVector(torch.where(mask, yv.local, fill), part, yv.rank)
    return {"dot": float(dist_dot(xv, yv, executor=ex)),
            "norm": float(dist_norm2(xv, executor=ex)),
            "x": _np(xv.to_global()),
            "axpy": _np(dist_axpy(2.0, xv, yv, executor=ex).to_global()),
            "scal": _np(dist_scal(-3.0, xv, executor=ex).to_global()),
            "axis_size": axis_size()}


def _precond(case, ex, device) -> dict:
    from repro_torch.distributed import dist_preconditioner

    Ad = _matrix(case, device)
    M = dist_preconditioner(Ad, case["kind"], executor=ex,
                            **(case.get("precond_opts") or {}))
    return {"y": _np(M.apply(_vec(case["v"], case, device), executor=ex))}


def _shard_batch(case, ex, device) -> dict:
    from repro_torch.distributed import comm
    from repro_torch.launch import batch_solve
    from repro_torch.solvers.common import Stop

    A, B, xstar = batch_solve.build_batch(case["nb"], case["n"],
                                          fmt=case["fmt"], device=device)
    rank, size = comm.world()
    A_r, B_r = batch_solve.shard_batch(A, B, rank=rank, world_size=size)
    res = batch_solve.solve_batch(A_r, B_r, stop=Stop(*case["stop"]),
                                  executor=ex)
    return {"values": _np(A_r.values), "B": _np(B_r), "x": _np(res.x),
            "iterations": _np(res.iterations)}


def _spmv(case, ex, device) -> dict:
    Ad = _matrix(case, device)
    return {"y": _np(Ad.apply(_vec(case["x"], case, device), executor=ex))}


_OPS = {"spmv": _spmv, "solve": _solve, "blas": _blas, "precond": _precond,
        "shard_batch": _shard_batch}


def run_cases(cases: List[dict], device: str = "cpu",
              executor: str = "torch") -> List[dict]:
    """Run every case on this rank; one result dict a case, with ``rank``."""
    from repro_torch.core import make_executor
    from repro_torch.distributed import comm

    ex = make_executor(executor, device=device)
    rank, _ = comm.world()
    out = []
    for case in cases:
        res = _OPS[case["op"]](case, ex, device)
        res["rank"] = rank
        out.append(res)
    return out
