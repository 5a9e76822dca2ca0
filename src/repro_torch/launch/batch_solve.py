"""Batched-solve entry point: thousands of small systems in one batched solve.

Builds ``nb`` shifted-tridiagonal systems of size ``n`` (the diagonal shift
varies across the batch, so per-system iteration counts differ), solves them
with masked batched CG or BiCGSTAB and reports per-system convergence and the
error against the known solutions.  It runs on the card (the CUDA executor)
unless ``--device cpu`` is given, and raises without a card::

    python -m repro_torch.launch.batch_solve                    # 256 x 64, the card
    python -m repro_torch.launch.batch_solve --batch 16384 --n 1024 --precond jacobi
    python -m repro_torch.launch.batch_solve --smoke --device cpu --executor torch

:func:`shard_batch` gives one rank of a ``torch.distributed`` world its
rows of the batch (the JAX package places the batch on a device mesh).
Exits 0 when every system converged, 1 otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import batch as batch_lib
from repro_torch import kernels
from repro_torch.core import default_device, make_executor
from repro_torch.core.executor import synchronize
from repro_torch.observability import trace
from repro_torch.solvers.common import Stop
from repro_torch.sparse.formats import _device

__all__ = ["BatchRun", "build_batch", "shard_batch", "solve_batch", "run",
           "main"]


def _tridiagonal_batch(nb: int, n: int, fmt: str, device):
    """The symmetric systems as the JAX package's dense stack converts them,
    built without the dense stack: row i holds columns i-1, i, i+1 (those
    that exist) in order, diagonal ``3 + 2 (b % 8)``, off-diagonals -1; ELL
    pads the two end rows with (column 0, value 0).  Also returns the host
    ``(indptr, indices, values)``."""
    i = np.arange(n, dtype=np.int64)
    rows = np.concatenate([i[1:], i, i[:-1]])
    cols = np.concatenate([i[:-1], i, i[1:]])
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    on_diag = rows == cols
    diag = (3.0 + 2.0 * (np.arange(nb) % 8)).astype(np.float32)
    values = np.where(on_diag[None, :], diag[:, None], np.float32(-1.0))
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(rows, minlength=n))
    A = batch_lib.BatchCsr(
        indptr=torch.as_tensor(indptr.astype(np.int32), device=device),
        indices=torch.as_tensor(cols.astype(np.int32), device=device),
        values=torch.as_tensor(values.astype(np.float32), device=device),
        shape=(n, n),
    )
    if fmt == "ell":
        A = batch_lib.batch_ell_from_batch_csr(A)
    return A, (indptr, cols, values)


def build_batch(nb: int, n: int, *, fmt: str = "ell", nonsym: bool = False,
                seed: int = 0, device=None):
    """``(A, B, xstar)``: ``nb`` shifted-tridiagonal systems of size ``n``
    with known solutions ``xstar`` (host numpy) and ``B = A xstar``.

    The draws from ``default_rng(seed)`` are the JAX package's: ``nonsym``
    first draws one ``(n, n)`` normal per system for a strictly upper
    perturbation (BiCGSTAB territory), then ``xstar``.  The nonsymmetric
    systems are dense per system and are built from a dense stack (small n
    only); the symmetric ones are built directly in the batched format.
    """
    if fmt not in ("ell", "csr"):
        raise ValueError(f"unknown batched format {fmt!r} (ell | csr)")
    dev = _device(device)
    rng = np.random.default_rng(seed)
    if nonsym:
        idx = np.arange(n)
        stack = np.zeros((nb, n, n), np.float32)
        for b in range(nb):
            a = stack[b]
            a[idx, idx] = 3.0 + 2.0 * (b % 8)
            a[idx[1:], idx[:-1]] = -1.0
            a[idx[:-1], idx[1:]] = -1.0
            a += np.triu(rng.normal(size=(n, n)).astype(np.float32) * 0.05, 1)
        xstar = rng.normal(size=(nb, n)).astype(np.float32)
        B = np.einsum("bmn,bn->bm", stack, xstar)
        A = (batch_lib.batch_ell_from_dense(stack, device=dev) if fmt == "ell"
             else batch_lib.batch_csr_from_dense(stack, device=dev))
    else:
        xstar = rng.normal(size=(nb, n)).astype(np.float32)
        A, (indptr, cols, values) = _tridiagonal_batch(nb, n, fmt, dev)
        # every row holds at least its diagonal, so each row is one segment
        prod = values.astype(np.float64) * xstar[:, cols]
        B = np.add.reduceat(prod, indptr[:-1], axis=1).astype(np.float32)
    return A, torch.as_tensor(B, device=dev), xstar


def shard_batch(A, B, *, rank: Optional[int] = None,
                world_size: Optional[int] = None):
    """This rank's systems of the batch: the values and right-hand sides cut
    on the batch axis (a uniform split, the first ``nb % P`` ranks one system
    more), the shared index structure whole (it is the same for every
    system).  ``rank`` / ``world_size`` default to the process group's."""
    from repro_torch.distributed import Partition, comm

    if rank is None or world_size is None:
        rank, world_size = comm.world()
    lo, hi = Partition.uniform(A.num_batch, world_size).range_of(rank)
    return dataclasses.replace(A, values=A.values[lo:hi]), B[lo:hi]


def solve_batch(A, B, *, solver: str = "cg", precond: str = "none",
                stop: Stop = Stop(), executor=None):
    """One batched solve; ``precond`` is ``none`` or ``jacobi``."""
    fn = {"cg": batch_lib.batch_cg, "bicgstab": batch_lib.batch_bicgstab}[solver]
    M = (batch_lib.batch_jacobi_preconditioner(A, executor=executor)
         if precond == "jacobi" else None)
    return fn(A, B, stop=stop, M=M, executor=executor)


@dataclasses.dataclass(frozen=True)
class BatchRun:
    """What a run built and measured; ``ok`` when every system
    converged."""

    ok: bool
    A: object
    B: torch.Tensor
    xstar: np.ndarray
    result: object  # BatchSolveResult
    stop: Stop
    executor: object
    #: host seconds of the solve (preconditioner setup included), ending in
    #: a device synchronize
    seconds: float
    #: kernel launches counted by the wrappers during the solve
    launches: Dict[str, int]
    #: max |x - xstar| over the batch
    error: float


def report(res, xstar, wall: float) -> float:
    iters = res.iterations.cpu().numpy()
    conv = res.converged.cpu().numpy()
    rnorm = res.residual_norms.cpu().numpy()
    err = float(np.abs(res.x.cpu().numpy() - xstar).max()) if xstar.size else 0.0
    print(f"batch_solve: {res.num_batch} systems in {wall * 1e3:.1f} ms")
    if iters.size:
        print(f"  converged {int(conv.sum())}/{conv.size}  iterations "
              f"min/median/max = {iters.min()}/{int(np.median(iters))}/"
              f"{iters.max()}  distinct counts = {len(np.unique(iters))}")
        print(f"  residual max = {rnorm.max():.3e}  error vs known solution = "
              f"{err:.3e}")
    return err


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small end-to-end run (64 systems of 48 rows)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--n", type=int, default=64, help="rows per system")
    ap.add_argument("--solver", default="cg", choices=("cg", "bicgstab"))
    ap.add_argument("--format", default="ell", choices=("ell", "csr"),
                    dest="fmt")
    ap.add_argument("--precond", default="none", choices=("none", "jacobi"))
    ap.add_argument("--executor", default="cuda",
                    help="executor kind (cuda | torch | reference) or hardware "
                         "target name (default: the CUDA kernels on the card)")
    ap.add_argument("--device", default=None,
                    help="device of the run (default: the card; 'cpu' asks for "
                         "the CPU with --executor torch|reference)")
    ap.add_argument("--max-iters", type=int, default=500)
    ap.add_argument("--tol", type=float, default=1e-6)
    trace.add_cli_flag(ap)
    return ap


def run(argv=None) -> BatchRun:
    """Parse ``argv`` as :func:`main` does, run, print the report and return
    the :class:`BatchRun`."""
    ap = _parser()
    args = ap.parse_args(argv)
    device = torch.device(args.device) if args.device else default_device()
    ex = make_executor(args.executor, device=device)
    if ex.kernel_space == "cuda" and device.type != "cuda":
        ap.error("the cuda executor runs on the card; use --executor "
                 "torch|reference with --device cpu")
    trace.enable_from_args(args)

    nb = 64 if args.smoke else args.batch
    n = 48 if args.smoke else args.n
    print(f"batch_solve: {nb} x ({n}x{n}) {args.fmt} systems, "
          f"{args.solver}/{args.precond}, executor {ex.name} on {ex.device}",
          flush=True)
    A, B, xstar = build_batch(nb, n, fmt=args.fmt,
                              nonsym=(args.solver == "bicgstab"), device=device)
    stop = Stop(max_iters=args.max_iters, reduction_factor=args.tol)

    synchronize()
    k0 = kernels.launch_counts()
    t0 = time.perf_counter()
    res = solve_batch(A, B, solver=args.solver, precond=args.precond,
                      stop=stop, executor=ex)
    synchronize()
    wall = time.perf_counter() - t0
    k1 = kernels.launch_counts()
    err = report(res, xstar, wall)
    launches = {k: k1[k] - k0[k] for k in k1}
    print(f"  kernel launches {({k: v for k, v in launches.items() if v})}")
    ok = bool(res.converged.all())
    if not ok:
        print("batch_solve: NOT all systems converged")
    if args.trace:
        trace.export(args.trace)
        trace.set_tracer(None)
        print(f"  trace -> {args.trace}")
    return BatchRun(ok=ok, A=A, B=B, xstar=xstar, result=res, stop=stop,
                    executor=ex, seconds=wall, launches=launches, error=err)


def main(argv=None) -> int:
    return 0 if run(argv).ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
