"""Distributed-solve entry point: one Krylov solve split over a world of ranks.

The distributed twin of :mod:`repro_torch.launch.batch_solve`: build a
sparse SPD (or perturbed nonsymmetric) system, split its rows over ``P``
ranks (:class:`~repro_torch.distributed.Partition` + ``DistCsr`` /
``DistEll``) and hand it to the unchanged solver entry point; ``krylov.cg``
sees the distributed operand and runs the iteration on every rank (local
SpMV + halo exchange, reductions summed over the ranks).  Rank 0 checks the
run against the single-card solve: converged, iterations within 1 (when the
preconditioner is the same), solutions within 1e-3.  It runs on the card
(the CUDA kernels, NCCL, one card a rank; ``--shards`` is clamped to the
cards there are) unless ``--device cpu`` is given (gloo)::

    python -m repro_torch.launch.dist_solve --n 1048576 --format ell --solver cg --precond jacobi
    python -m repro_torch.launch.dist_solve --smoke --device cpu --executor torch --shards 4

``--shards P`` spawns ``P`` ranks (one runs in this process).  The system
is built from the stencil without the dense matrix; its arrays equal the
JAX package's.  The nonsymmetric variant (``bicgstab`` / ``cgs`` /
``gmres``) draws an ``n x n`` random mask, row block by row block, so it
takes time in ``n**2``.  Ends with ``DIST-PARITY: PASS|FAIL``; exits 0 on
PASS, 1 otherwise.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.observability import trace

__all__ = ["build_system", "run", "main"]

#: rows of the random mask drawn at a time for the nonsymmetric variant
_MASK_ROWS = 256


def build_system(n: int, *, nonsym: bool = False, seed: int = 0):
    """``((indptr, indices, values), xstar, b)``: the JAX package's system
    as host CSR (f32), without the dense matrix.

    A 2-D five-point stencil (diagonal 4, neighbours -1) on the largest
    square grid of side ``side = floor(sqrt(n))``, row ``r`` at grid point
    ``divmod(r, side)``, SPD; ``nonsym`` adds 0.05 at the strictly-upper
    entries where ``default_rng(seed).random((n, n)) < min(1, 8 / n)``
    (drawn in blocks of rows, the same stream).  Then ``xstar`` =
    ``normal(size=n)`` from the same generator and ``b = A xstar``, summed
    in f64 and rounded to f32.
    """
    rng = np.random.default_rng(seed)
    side = max(1, int(np.sqrt(n)))
    r = np.arange(n, dtype=np.int64)
    j = r % side
    rows = [r]
    cols = [r]
    vals = [np.full(n, 4.0, np.float32)]
    for keep, off in ((j > 0, -1), ((j < side - 1) & (r + 1 < n), 1),
                      (r >= side, -side), (r + side < n, side)):
        rows.append(r[keep])
        cols.append(r[keep] + off)
        vals.append(np.full(int(keep.sum()), -1.0, np.float32))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = np.concatenate(vals)
    if nonsym:
        p = min(1.0, 8.0 / n)
        extra_r, extra_c = [], []
        for lo in range(0, n, _MASK_ROWS):
            hi = min(n, lo + _MASK_ROWS)
            rr, cc = np.nonzero(rng.random((hi - lo, n)) < p)
            upper = cc > rr + lo
            extra_r.append(rr[upper] + lo)
            extra_c.append(cc[upper])
        er, ec = np.concatenate(extra_r), np.concatenate(extra_c)
        rows = np.concatenate([rows, er])
        cols = np.concatenate([cols, ec])
        vals = np.concatenate([vals, np.full(er.size, 0.05, np.float32)])
    # merge a stencil entry the mask hit (stencil value first, as the dense
    # a += 0.05 adds in f32), then CSR order
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    key, vals = key[order], vals[order]
    starts = np.flatnonzero(np.concatenate([[True], key[1:] != key[:-1]]))
    merged = np.add.reduceat(vals, starts)
    urows, ucols = key[starts] // n, key[starts] % n
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(urows, minlength=n))
    xstar = rng.normal(size=n).astype(np.float32)
    b = np.bincount(urows, weights=merged.astype(np.float64) * xstar[ucols],
                    minlength=n)
    return (indptr, ucols.astype(np.int64), merged), xstar, b.astype(np.float32)


def _rank_main(args: dict) -> Optional[dict]:
    """One rank's run: build the system, split it, solve it distributed (and
    on one card, rank 0 only); rank 0 returns the report."""
    from repro_torch import kernels
    from repro_torch.core import make_executor
    from repro_torch.core.executor import synchronize
    from repro_torch.distributed import DistCsr, DistEll, Partition, comm
    from repro_torch.solvers import krylov
    from repro_torch.solvers.common import Stop
    from repro_torch.sparse import csr_from_arrays, ell_from_csr_host

    rank, shards = comm.world()
    device = torch.device(args["device"])
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    ex = make_executor(args["executor"], device=device)
    if rank == 0 and args["trace"]:
        trace.enable(args["trace"])
    n = args["n"]
    host, xstar, b_np = build_system(n, nonsym=args["nonsym"])
    shape = (n, n)
    if args["fmt"] == "csr":
        A = csr_from_arrays(*host, shape, device=device)
        cls = DistCsr
    else:
        A = ell_from_csr_host(*host, shape, device=device)
        cls = DistEll
    part = Partition.uniform(n, shards)
    Ad = cls.from_host(*host, part, device=device)
    b = torch.as_tensor(b_np, device=device)
    stop = Stop(max_iters=args["max_iters"], reduction_factor=args["tol"])
    fn = getattr(krylov, args["solver"])
    M = None if args["precond"] == "none" else args["precond"]

    single = fn(A, b, stop=stop, M=M, executor=ex) if rank == 0 else None
    synchronize()
    comm.reset_collective_counts()
    k0 = kernels.launch_counts()
    t0 = time.perf_counter()
    res = fn(Ad, b, stop=stop, M=M, executor=ex)
    synchronize()
    wall = time.perf_counter() - t0
    k1 = kernels.launch_counts()
    counts = comm.collective_counts()
    if rank != 0:
        return None
    if args["trace"]:
        trace.export(args["trace"])
        trace.set_tracer(None)
    x = res.x.cpu().numpy()
    return {
        "n": n, "nnz": Ad.nnz, "shards": shards, "sizes": part.part_sizes,
        "halo_cols": Ad.num_halo_cols, "iterations": int(res.iterations),
        "single_iterations": int(single.iterations),
        "residual_norm": float(res.residual_norm),
        "converged": bool(res.converged), "wall_s": wall,
        "error": float(np.abs(x - xstar).max()),
        "diff": float(np.abs(x - single.x.cpu().numpy()).max()),
        "collectives": counts,
        "launches": {k: k1[k] - k0[k] for k in k1 if k1[k] != k0[k]},
    }


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small end-to-end run (n = 225) with the parity check")
    ap.add_argument("--n", type=int, default=1024, help="global rows")
    ap.add_argument("--solver", default="cg",
                    choices=("cg", "fcg", "bicgstab", "cgs", "gmres"))
    ap.add_argument("--format", default="csr", choices=("csr", "ell"),
                    dest="fmt")
    ap.add_argument("--precond", default="none",
                    choices=("none", "jacobi", "block_jacobi"))
    ap.add_argument("--shards", type=int, default=0,
                    help="ranks (default: every card; 1 with --device cpu)")
    ap.add_argument("--executor", default="cuda",
                    help="executor kind (cuda | torch | reference) or hardware "
                         "target name (default: the CUDA kernels on the card)")
    ap.add_argument("--device", default=None,
                    help="device of the run (default: the card; 'cpu' asks for "
                         "the CPU with --executor torch|reference)")
    ap.add_argument("--max-iters", type=int, default=500)
    ap.add_argument("--tol", type=float, default=1e-6)
    trace.add_cli_flag(ap)  # rank 0's dispatches
    return ap


def run(argv=None) -> dict:
    """Parse ``argv`` as :func:`main` does, run the world, print the report
    and return rank 0's report with ``ok``."""
    from repro_torch.core import default_device
    from repro_torch.distributed import comm

    ap = _parser()
    args = ap.parse_args(argv)
    device = torch.device(args.device) if args.device else default_device()
    if args.executor in ("cuda", "h100") and device.type != "cuda":
        ap.error("the cuda executor runs on the card; use --executor "
                 "torch|reference with --device cpu")
    n = 225 if args.smoke else args.n
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        shards = args.shards or cards
        if shards > cards:
            print(f"dist_solve: clamping --shards {shards} to {cards} cards")
            shards = cards
        backend = "nccl"
        threads = None
        from repro_torch.kernels import _build

        _build.build()  # once, before the ranks start
    else:
        shards = args.shards or 1
        backend = "gloo"
        # ranks that share the host's cores split its threads
        threads = max(1, (os.cpu_count() or 1) // shards)
    nonsym = args.solver in ("bicgstab", "cgs", "gmres")
    rank_args = {"n": n, "nonsym": nonsym, "fmt": args.fmt,
                 "solver": args.solver, "precond": args.precond,
                 "device": str(device), "executor": args.executor,
                 "max_iters": args.max_iters, "tol": args.tol,
                 "trace": args.trace}
    rep = comm.run_world(_rank_main, shards, (rank_args,), backend=backend,
                         threads=threads, in_process=shards == 1)[0]
    print(f"dist_solve: n={n} {args.fmt} nnz={rep['nnz']} over {shards} "
          f"ranks ({backend}; sizes {min(rep['sizes'])}..{max(rep['sizes'])}, "
          f"halo cols {min(rep['halo_cols'])}..{max(rep['halo_cols'])}), "
          f"{args.solver}/{args.precond}, executor={args.executor} on {device}")
    k = max(rep["iterations"], 1)
    print(f"  distributed: {rep['iterations']} iters, residual "
          f"{rep['residual_norm']:.3e}, {rep['wall_s'] * 1e3:.1f} ms   "
          f"single-card: {rep['single_iterations']} iters")
    print(f"  collectives {rep['collectives']} "
          f"({rep['collectives']['reduction'] / k:.2f} reductions an "
          f"iteration); kernel launches {rep['launches']}")
    print(f"  error vs known solution = {rep['error']:.3e}, vs single-card = "
          f"{rep['diff']:.3e}")
    # block-Jacobi is rank-local: blocks cut by a rank boundary make another
    # preconditioner, and only the solutions must agree then
    same_preconditioner = args.precond != "block_jacobi" or shards == 1
    iters_ok = (abs(rep["iterations"] - rep["single_iterations"]) <= 1
                if same_preconditioner else True)
    rep["ok"] = bool(rep["converged"] and iters_ok and rep["diff"] < 1e-3)
    print(f"DIST-PARITY: {'PASS' if rep['ok'] else 'FAIL'}")
    if args.trace:
        print(f"  trace -> {args.trace}")
    return rep


def main(argv=None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
