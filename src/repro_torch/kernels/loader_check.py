"""Drive the main path on the card with the kernels' library linked to a chosen
CUDA runtime: a check of the loader, meant to run under ``compute-sanitizer``.

    PYTHONPATH=src PYTORCH_NO_CUDA_MEMORY_CACHING=1 \\
        compute-sanitizer --tool memcheck --error-exitcode 9 \\
        python -m repro_torch.kernels.loader_check --cudart static

Each rep builds the main path's ``poisson_3d(128)`` as ELL on the card,
generates adaptive block-Jacobi (the blocks are inverted on the card), runs
``iters`` fused CG iterations through the CUDA executor (all four kernels
launch) and checks that the iterate is finite and every kernel launched.  ``--cudart static`` links
the library against a static copy of the CUDA runtime instead of the shared
one PyTorch has loaded (it builds a library of its own name).  With
``PYTORCH_NO_CUDA_MEMORY_CACHING=1`` every tensor is its own allocation, so
memcheck sees an access past a tensor's end.  Exits non-zero on failure.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cudart", choices=("shared", "static"), default="shared")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    from repro_torch import kernels as K
    from repro_torch.core import make_executor
    from repro_torch.kernels import _build
    from repro_torch.solvers import Stop, cg
    from repro_torch.sparse import ell_from_csr_host, gallery

    _build.LINK_FLAGS = ("-shared", "-cudart", args.cudart)
    _build.load()
    print(f"[loader] cudart {args.cudart}: {_build.last_build.get('path')}",
          flush=True)
    ip, ix, v, shape = gallery.poisson_3d(128)
    b_np = np.random.default_rng(0).standard_normal(shape[0]).astype(np.float32)
    for rep in range(args.reps):
        t0 = time.perf_counter()
        A = ell_from_csr_host(ip, ix, v, shape, device="cuda")
        K.reset_launch_counts()
        res = cg(A, torch.from_numpy(b_np).cuda(), M="block_jacobi",
                 precond_opts={"block_size": 8, "adaptive": True},
                 stop=Stop(max_iters=args.iters, reduction_factor=1e-30),
                 executor=make_executor("cuda"))
        torch.cuda.synchronize()
        launches = K.launch_counts()
        ok = bool(torch.isfinite(res.x).all()) and min(launches.values()) > 0
        print(f"[loader] rep {rep}: {shape[0]} rows, {res.iterations} "
              f"iterations, launches {launches}, finite and launched {ok}, "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        if not ok:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
