"""AMG check: hierarchy report and iteration-cut gate against block-Jacobi CG.

Builds ``poisson_2d(n_side)`` as CSR, sets up the smoothed-aggregation
:class:`repro_torch.precond.amg.Multigrid` hierarchy and runs preconditioned
CG twice — ``M=<amg>`` against the block-Jacobi baseline.  It prints the
hierarchy (rows per level, operator complexity) and both solves, and ends
with a greppable ``AMG-GATE: PASS|FAIL`` line, passing when both solves
converged, the hierarchy coarsened (more than one level) and AMG cut CG's
iterations by at least ``--iter-cut``.

It runs on the card (:func:`repro_torch.core.default_executor`, the CUDA
kernels) unless asked otherwise::

    python -m repro_torch.launch.amg_check                  # poisson_2d(1024)
    python -m repro_torch.launch.amg_check --executor torch --device cpu --smoke

``--trace OUT_JSON`` writes a Chrome trace of the run's dispatches and the
setup's spans.  Exits 0 when the gate passes, 1 when it fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from collections import Counter
from typing import Dict

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core import LinOp, default_device, default_executor, make_executor
from repro_torch.core.executor import synchronize
from repro_torch.observability import trace
from repro_torch.precond import make_preconditioner
from repro_torch.precond.amg import Multigrid
from repro_torch.solvers import SolveResult, Stop, cg
from repro_torch.sparse import Csr, csr_from_arrays
from repro_torch.sparse.gallery import poisson_2d

__all__ = ["AmgCheck", "run_amg_check", "main"]

@dataclasses.dataclass(frozen=True)
class AmgCheck:
    """What a run built and measured, and the gate's verdict ``ok``.

    The phases, in order: ``amg_setup``, ``block_jacobi_setup``,
    ``block_jacobi_solve``, ``amg_solve``.  Times are host seconds around
    work that ends in a device synchronize; the solve times include CG's
    symmetry probe.
    """

    ok: bool
    A: Csr
    b: torch.Tensor
    M: Multigrid
    M_bj: LinOp
    amg: SolveResult
    block_jacobi: SolveResult
    seconds: Dict[str, float]
    #: phase -> kernel launches counted by the wrappers during that phase
    launches: Dict[str, Dict[str, int]]
    #: phase -> registry dispatches of the executor during that phase
    dispatches: Dict[str, Dict[str, int]]


def run_amg_check(
    n_side: int,
    *,
    cycle: str = "v",
    theta: float = 0.08,
    iter_cut: float = 3.0,
    max_iters: int = 2000,
    tol: float = 1e-6,
    executor=None,
) -> AmgCheck:
    """Run the check on ``poisson_2d(n_side)`` on the executor's device.

    Returns an :class:`AmgCheck`: the gate's verdict ``ok``, both
    preconditioners, both :class:`SolveResult` s, phase times and the
    launches and dispatches of each phase.
    """
    ex = executor if executor is not None else default_executor()
    indptr, indices, values, shape = poisson_2d(n_side)
    A = csr_from_arrays(indptr, indices, values, shape, device=ex.device)
    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.normal(size=shape[0]).astype(np.float32)).to(ex.device)
    stop = Stop(max_iters=max_iters, reduction_factor=tol)

    print(f"amg_check: poisson_2d({n_side}) -> {shape[0]} rows, "
          f"{indices.size} nnz, cycle={cycle}, theta={theta:g}, "
          f"executor {ex.name} on {ex.device}", flush=True)

    seconds: Dict[str, float] = {}
    launches: Dict[str, Dict[str, int]] = {}
    dispatches: Dict[str, Dict[str, int]] = {}

    def phase(name, fn):
        synchronize()
        k0 = kernels.launch_counts()
        d0 = Counter(ex.dispatch_log)
        t0 = time.perf_counter()
        out = fn()
        synchronize()
        seconds[name] = time.perf_counter() - t0
        k1 = kernels.launch_counts()
        launches[name] = {k: k1[k] - k0[k] for k in k1}
        dispatches[name] = dict(Counter(ex.dispatch_log) - d0)
        return out

    M_amg = phase("amg_setup", lambda: make_preconditioner(
        A, "amg", executor=ex, cycle=cycle, theta=theta))
    rows = [int(L.A.shape[0]) for L in M_amg.levels]
    nnzs = [int(L.A.nnz) for L in M_amg.levels]
    complexity = sum(nnzs) / max(nnzs[0], 1) if nnzs else 1.0
    print(f"  hierarchy: {M_amg.num_levels} levels, rows {rows}, "
          f"operator complexity {complexity:.2f}, "
          f"setup {seconds['amg_setup']:.2f} s", flush=True)

    M_bj = phase("block_jacobi_setup",
                 lambda: make_preconditioner(A, "block_jacobi", executor=ex))
    res_bj = phase("block_jacobi_solve",
                   lambda: cg(A, b, stop=stop, M=M_bj, executor=ex))
    res_amg = phase("amg_solve",
                    lambda: cg(A, b, stop=stop, M=M_amg, executor=ex))
    it_bj = int(res_bj.iterations)
    it_amg = int(res_amg.iterations)
    ratio = it_bj / max(it_amg, 1)
    for label, res, key in (("block_jacobi-cg: ", res_bj, "block_jacobi_solve"),
                            ("amg-cg:          ", res_amg, "amg_solve")):
        print(f"  {label}{int(res.iterations)} iters, "
              f"rnorm {float(res.residual_norm):.3e}, "
              f"converged {bool(res.converged)}, "
              f"solve {seconds[key]:.3f} s", flush=True)
    print(f"  iteration cut: {ratio:.1f}x (gate: >= {iter_cut:g}x)")

    ok = (
        bool(res_bj.converged)
        and bool(res_amg.converged)
        and M_amg.num_levels > 1
        and ratio >= iter_cut
    )
    print(f"AMG-GATE: {'PASS' if ok else 'FAIL'}", flush=True)
    return AmgCheck(ok=ok, A=A, b=b, M=M_amg, M_bj=M_bj, amg=res_amg,
                    block_jacobi=res_bj, seconds=seconds, launches=launches,
                    dispatches=dispatches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small run (64x64 grid, 3x gate)")
    ap.add_argument("--n-side", type=int, default=1024,
                    help="Poisson grid side (rows = n_side^2)")
    ap.add_argument("--cycle", default="v", choices=("v", "w"))
    ap.add_argument("--theta", type=float, default=0.08,
                    help="strength-of-connection threshold")
    ap.add_argument("--iter-cut", type=float, default=3.0,
                    help="gate: AMG must cut CG iterations by this factor")
    ap.add_argument("--max-iters", type=int, default=2000)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--executor", default="cuda",
                    choices=("cuda", "torch", "reference"),
                    help="kernel space (default: the CUDA kernels on the card)")
    ap.add_argument("--device", default=None,
                    help="device of the torch/reference executors (default: "
                         "the card; 'cpu' asks for the CPU)")
    trace.add_cli_flag(ap)
    args = ap.parse_args(argv)

    if args.executor == "cuda":
        if args.device is not None and not args.device.startswith("cuda"):
            ap.error("the cuda executor runs on the card; use --executor "
                     "torch|reference with --device cpu")
        ex = default_executor()
    else:
        device = args.device if args.device is not None else default_device()
        ex = make_executor(args.executor, device=device)
    trace.enable_from_args(args)
    r = run_amg_check(
        64 if args.smoke else args.n_side,
        cycle=args.cycle,
        theta=args.theta,
        iter_cut=args.iter_cut,
        max_iters=args.max_iters,
        tol=args.tol,
        executor=ex,
    )
    if args.trace:
        trace.export(args.trace)
        trace.reset()
        print(f"  trace -> {args.trace}")
    return 0 if r.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
