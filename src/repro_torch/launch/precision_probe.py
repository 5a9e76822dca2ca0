"""Which precisions the f32-sensitive Krylov solvers reach their stop in.

    PYTHONPATH=src python -m repro_torch.launch.precision_probe [--out JSON]
    PYTHONPATH=src python -m repro_torch.launch.precision_probe --device cpu \
        --executor torch --n-side 32 --cd-side 64

runs, in f32 and in f64, (1) classic and pipelined CG with block-Jacobi 8
on ``poisson_3d(n_side)`` and (2) CGS and BiCGSTAB with block-Jacobi 8 and
with ParILU on ``convection_diffusion_2d(cd_side, Pe 5, upwind)``, each
under ``Stop(3000, 1e-6)``, through the executor (``cuda`` on the card by
default, and its torch space beside it), and prints one line a solve:
iterations, converged, the smallest recursive residual reached and the
true relative residual (f64 plain SpMV).  ``chip_smoke.py`` runs pipelined
CG and CGS in f64 because of what this shows at its sizes.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.core import make_executor
from repro_torch.kernels import spmv_ell_plain
from repro_torch.precond import block_jacobi
from repro_torch.solvers import Stop, bicgstab, cg, cgs, parilu_preconditioner
from repro_torch.sparse import csr_from_arrays, ell_from_csr_host, gallery

STOP = Stop(max_iters=3000, reduction_factor=1e-6)


def _solve(fn, A, b, M, ex, **kw) -> dict:
    res = fn(A, b, M=M, stop=STOP, executor=ex, history=True, **kw)
    hist = res.history[:res.iterations]
    hist = hist[torch.isfinite(hist)]
    ax = spmv_ell_plain(A.col_idx, A.values.double(), res.x.double())
    true = float((b.double() - ax).norm() / b.double().norm())
    return {"iterations": res.iterations, "converged": res.converged,
            "min_relative_recursive": (float(hist.min() / b.norm())
                                       if hist.numel() else None),
            "true_relative": true if true == true else None}


def probe(n_side: int, cd_side: int, device: str, executor: str) -> list:
    rows = []
    spaces = [executor] + (["torch"] if executor == "cuda" else [])
    rng = np.random.default_rng(0)
    systems = (("poisson_3d", gallery.poisson_3d(n_side)),
               ("convection_diffusion_2d",
                gallery.convection_diffusion_2d(cd_side, peclet=5.0,
                                                scheme="upwind")))
    for (name, (ip, ix, v, shape)), bn in zip(
            systems, (rng.standard_normal(n_side ** 3),
                      rng.standard_normal(cd_side ** 2))):
        for dtype in (torch.float32, torch.float64):
            vals = v.astype(np.float64 if dtype == torch.float64 else np.float32)
            A = ell_from_csr_host(ip, ix, vals, shape, device=device)
            b = torch.as_tensor(bn, dtype=dtype, device=device)
            bj = block_jacobi(A, 8, executor=make_executor(executor,
                                                           device=device))
            if name == "poisson_3d":
                runs = [("cg", cg, "block_jacobi", bj, {}),
                        ("pipelined_cg", cg, "block_jacobi", bj,
                         {"pipeline": True})]
            else:
                pi = parilu_preconditioner(csr_from_arrays(
                    ip, ix, vals, shape, device=device))
                runs = [(s, f, m, M, {}) for s, f in (("cgs", cgs),
                                                      ("bicgstab", bicgstab))
                        for m, M in (("block_jacobi", bj), ("parilu", pi))]
            for solver, fn, m, M, kw in runs:
                for space in spaces:
                    ex = make_executor(space, device=device)
                    row = {"matrix": name, "rows": shape[0],
                           "dtype": str(dtype).removeprefix("torch."),
                           "solver": solver, "precond": m, "space": space,
                           **_solve(fn, A, b, M, ex, **kw)}
                    print(json.dumps(row), flush=True)
                    rows.append(row)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-side", type=int, default=128)
    ap.add_argument("--cd-side", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--executor", default="cuda",
                    choices=("cuda", "torch", "reference"))
    ap.add_argument("--out", default=None, help="write the rows as JSON here")
    args = ap.parse_args()
    rows = probe(args.n_side, args.cd_side, args.device, args.executor)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
