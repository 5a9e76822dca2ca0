#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. card   — prints ``nvidia-smi``'s name and power limit of GPU 0;
2. build  — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
            with nvcc (sm_90a) and prints the build time;
3. kernels — at the main path's shapes, holds each kernel against its plain
            PyTorch version (stated tolerance) and times kernel, plain version
            and, where one exists, a single PyTorch library call (CUDA events,
            median of 30 runs, L2 flushed before each run);
4. path   — solves poisson_3d(128) (2,097,152 rows, ELL k = 7, f32) with
            block-Jacobi CG through the CUDA executor, checks convergence, the
            true residual and every kernel's launch count, and repeats the
            solve in the torch space on the card for comparison; a small solve
            is also held against the reference space on the CPU;
5. amg    — runs ``repro_torch.launch.amg_check`` on poisson_2d(1024)
            (1,048,576 rows, CSR, f32) through the CUDA executor: the
            smoothed-aggregation hierarchy (SpGEMM and transpose kernels), AMG-CG
            against block-Jacobi CG, the gate, each kernel's launch count
            against the hierarchy, the true residual, the setup split; then the
            same path in the torch space on the card (the hierarchy bitwise
            equal); then, at this path's shapes, spmv_ell on every level
            operator, axpy_norm at the outer CG's vectors and
            block_jacobi_apply at the baseline's blocks against their plain
            versions (phase 3's tolerances), and the two SpGEMM kernels at
            level 0's shapes (bitwise), with their times;
6. sellp  — Jacobi-CG on power_law_laplacian(2**21, seed=4) stored as SELL-P
            (C = 8, stride 8, f32) through the CUDA executor: convergence, the
            true residual, spmv_sellp's launch count against the loop's
            SpMVs, a repeat bit for bit, the torch space on the card, the
            storage ELL would need; spmv_sellp held against its plain version
            (per row, 2 (w + 1) eps relative to the row's magnitudes, w its
            slice's width) and timed, torch.sparse.mm on the CSR as library;
7. batch  — repro_torch.launch.batch_solve at 16,384 systems of 1,024 rows
            (f32 BatchEll, k = 3) with no preconditioner and with Jacobi,
            batch_cg with 8-row block-Jacobi, and BiCGSTAB at 1,024 x 64:
            every system converged, the error against the known solutions,
            each kernel's launches against the sweeps, a 4-sweep chunked
            advance bit for bit equal to the monolithic one, the torch space
            on the card (iterations within 1, x close); spmv_batch_ell
            (at the CG runs' and the BiCGSTAB run's operators), row-batched
            axpy_norm (at the CG runs' rows, one block each, and at
            256 x 1,024, rows cut into pieces) and block_jacobi_apply held
            and timed at this path's shapes (torch.sparse.mm on the
            block-diagonal CSR of all systems as spmv_batch_ell's library
            call).

It then prints one JSON line describing the kernels and, last, the
``{"ok": true, "device": ...}`` line.  A kernel's ``launches`` there is the
sum over the four paths' counted runs (phases 4 to 7; phase 7 counts its
four solves), each run counted from 0; ``launches_by_path`` gives each, and
block_jacobi_apply's storage variants carry the same per storage dtype.
``max_abs_err`` is the larger over the shapes the kernel was held at;
``at_amg_path_shape`` / ``at_batch_path_shape`` hold the times at those
paths' shapes of a kernel whose row is timed at phase 3's, and
``at_bicgstab_shape`` / ``at_row_pieces_shape`` those of phase 7's second
shapes.  It imports
nothing of JAX or of the JAX package.  Without a CUDA device, or without the
repository beside it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import collections
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 0
N_SIDE = 128
STOP_KW = dict(max_iters=3000, reduction_factor=1e-6)
PRECOND_OPTS = {"block_size": 8, "adaptive": True}
REPS = 30
#: the AMG path: amg_check on poisson_2d(1024) (1,048,576 rows); block-Jacobi
#: CG needs about 1,800 iterations there, AMG-CG about 15
AMG_N_SIDE = 1024
AMG_KW = dict(cycle="v", theta=0.08, tol=1e-6, max_iters=6000, iter_cut=5)
#: the SELL-P path: Jacobi-CG on power_law_laplacian(2**21, seed=4) (about 70
#: iterations; the longest row has 11,156 entries)
SELLP_N = 2 ** 21
SELLP_SEED = 4
#: the batched path: batch_solve's CG runs and its BiCGSTAB run
BATCH_ARGS = ["--batch", "16384", "--n", "1024"]
BATCH_BICGSTAB_ARGS = ["--batch", "1024", "--n", "64", "--solver", "bicgstab"]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# -- timing ----------------------------------------------------------------------


def device_ms(torch, fn, flush) -> float:
    """Median device time of ``fn`` in ms: CUDA events around each of REPS
    runs, with the L2 cache flushed before each.  A sleep kernel holds the
    stream while the host enqueues, so host overhead does not enter."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    torch.cuda._sleep(200_000_000)
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bounds(nbytes: float, flops: float, copy_bw: float) -> dict:
    """Least time for the work at the H100's published rates (HBM bytes/s,
    f32 flop/s; ``repro_torch.core.params.H100``), and at the measured copy
    bandwidth."""
    from repro_torch.core.params import H100

    t_bytes = nbytes / H100.hbm_bandwidth * 1e3
    t_ops = flops / H100.peak_flops_f32 * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "copy_bound_ms": nbytes / copy_bw * 1e3,
        "bytes": int(nbytes),
    }


# -- phases ------------------------------------------------------------------------


def phase_card(torch) -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    line = r.stdout.strip().splitlines()[0]
    say(line)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    return line


def phase_build() -> float:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load()
    seconds = time.perf_counter() - t0
    say(f"[build] {seconds:.2f} s -> {_build.last_build.get('path')}")
    for line in str(_build.last_build.get("log", "")).splitlines():
        if "registers" in line or line.startswith("=="):
            say(f"[build]   {line.strip()}")
    return seconds


def copy_bandwidth(torch) -> float:
    """Bytes/s of a 1 GiB device-to-device clone (read + write counted)."""
    src = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    flush = torch.empty(1, dtype=torch.uint8, device="cuda")
    ms = device_ms(torch, lambda: src.clone(), flush)
    del src
    bw = 2 * (1 << 30) / (ms * 1e-3)
    say(f"[kernels] 1 GiB clone: {ms:.3f} ms -> {bw / 1e9:.1f} GB/s")
    return bw


def tree_tol_rows(terms):
    """Tolerance of an f32 tree sum of each row of ``terms`` against the
    row's sum in f64, as a tensor (see :func:`tree_tol`)."""
    s = terms.double()
    total = (s * s).sum(dim=1)
    while s.shape[1] > 1:
        if s.shape[1] % 2:  # pad to even with a zero leaf
            padded = s.new_zeros(s.shape[0], s.shape[1] + 1)
            padded[:, :-1] = s
            s = padded
        s = s[:, 0::2] + s[:, 1::2]
        total = total + (s * s).sum(dim=1)
    return 16 * 2.0 ** -24 * total.sqrt()


def tree_tol(terms) -> float:
    """Tolerance of an f32 tree sum of ``terms`` against their sum in f64.

    Each addition rounds by at most u|s| (u = 2^-24), and the roundings act as
    independent (the probabilistic model of Higham and Mary), so the error's
    spread is about u sqrt(sum of s^2 over the tree's nodes / 3).  The nodes
    are those of a balanced pairwise tree, leaves (the f32 terms themselves)
    included; the tolerance is 16 u times that root-sum-square, over 25 times
    the spread.  For the random-sign w.y at m = 2M this is a few hundredths,
    so dropping a typical block partial (128 terms, tens in size) fails."""
    return float(tree_tol_rows(terms.flatten()[None])[0])


def check(name: str, err: float, tol: float) -> None:
    say(f"[kernels] {name}: max_abs_err {err:.3e} (tolerance {tol:.3e})")
    if not err <= tol:
        fail(f"{name} disagrees with its plain version: {err} > {tol}")


def kernel_row(torch, flush, copy_bw, name, src, line, err, kernel_fn,
               plain_fn, nbytes, flops, library_fn=None) -> dict:
    """One entry of the ``kernels`` line: the kernel's, its plain version's
    and (where one exists) a library call's device time, and the bounds."""
    entry = {
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{src}",
        "replaces": line,
        "max_abs_err": err,
        "ms": device_ms(torch, kernel_fn, flush),
        "plain_ms": device_ms(torch, plain_fn, flush),
        "library_ms": (device_ms(torch, library_fn, flush)
                       if library_fn is not None else None),
    }
    entry.update(bounds(nbytes, flops, copy_bw))
    say(f"[kernels] {name}: {entry['ms']:.4f} ms (plain {entry['plain_ms']:.4f}, "
        f"library {entry['library_ms']}, bound {entry['bound_ms']:.4f} "
        f"by {entry['bound_by']}, copy bound {entry['copy_bound_ms']:.4f})")
    return entry


def held_axpy_norm(torch, ex, x, w, where: str = "") -> dict:
    """Holds ``axpy_norm(alpha, x, w)`` against its plain version — z within
    2 eps of max |alpha x| + |w|, z.z against the f64 sum within tree_tol —
    and returns the rest of its ``kernel_row`` arguments."""
    from repro_torch import kernels as K

    eps = torch.finfo(torch.float32).eps
    n = x.numel()
    cfg = ex.launch_config("axpy_norm", {"n": n, "itemsize": 4})
    geo = dict(block_threads=cfg["block_threads"], grid_blocks=cfg["grid_blocks"])
    alpha = torch.tensor(-0.37, device="cuda")
    z, ss = K.axpy_norm(alpha, x, w, **geo)
    z_ref = K.axpy_norm_plain(alpha, x, w)[0]
    z64 = alpha.double() * x.double() + w.double()
    err_z = float((z - z_ref).abs().max())
    err_s = float((ss.double() - (z64 * z64).sum()).abs())
    check(f"axpy_norm z{where}", err_z,
          2 * eps * float((alpha.abs() * x.abs() + w.abs()).max()))
    check(f"axpy_norm z.z{where}", err_s, tree_tol(z64 * z64))
    return dict(err=max(err_z, err_s),
                kernel_fn=lambda: K.axpy_norm(alpha, x, w, **geo),
                plain_fn=lambda: K.axpy_norm_plain(alpha, x, w),
                nbytes=3 * n * 4 + 4, flops=4 * n)


def held_block_jacobi(torch, ex, inv, vp, where: str = "") -> dict:
    """Holds ``block_jacobi_apply(inv, vp)`` against its plain version —
    within 2 bs eps of max_b,i sum_j |inv_bij v_bj| — with the launch
    configuration the registry binding gives these blocks, and returns the
    rest of its ``kernel_row`` arguments (the library call is ``torch.bmm``
    on the blocks in f32)."""
    from repro_torch import kernels as K

    eps = torch.finfo(torch.float32).eps
    nb, bs = vp.shape
    bt = ex.launch_config("block_jacobi", {"nb": nb, "bs": bs})["block_threads"]
    inv32 = inv.float()
    yb = K.block_jacobi_apply(inv, vp, block_threads=bt)
    yb_ref = K.block_jacobi_apply_plain(inv, vp)
    err = float((yb - yb_ref).abs().max())
    sc = float(K.block_jacobi_apply_plain(inv32.abs(), vp.abs()).max())
    check(f"block_jacobi_apply[{inv.dtype}]{where}", err, 2 * bs * eps * sc)
    vcol = vp[:, :, None]
    return dict(err=err,
                kernel_fn=lambda: K.block_jacobi_apply(inv, vp, block_threads=bt),
                plain_fn=lambda: K.block_jacobi_apply_plain(inv, vp),
                nbytes=nb * bs * bs * inv.element_size() + 2 * nb * bs * 4,
                flops=2 * nb * bs * bs,
                library_fn=lambda: torch.bmm(inv32, vcol))


def held_batch_ell(torch, ex, A, X, where: str = "") -> dict:
    """Holds ``spmv_batch_ell`` on the BatchEll ``A`` and ``X`` against its
    plain version — within 8 k eps of max_b,i sum_j |a_bij x_bj| — with the
    launch configuration the registry binding gives this shape, and returns
    the rest of its ``kernel_row`` arguments (the library call is
    ``torch.sparse.mm`` on the block-diagonal CSR of all systems, the ELL
    padding stored as explicit zeros)."""
    from repro_torch import kernels as K

    eps = torch.finfo(torch.float32).eps
    nb, m, k = A.values.shape
    n = A.shape[1]
    cfg = ex.launch_config("spmv_batch_ell", {"nb": nb, "m": m, "k": k})
    geo = dict(block_threads=cfg["block_threads"], subgroup=cfg["subgroup"])
    y = K.spmv_batch_ell(A.col_idx, A.values, X, **geo)
    y_ref = K.spmv_batch_ell_plain(A.col_idx, A.values, X)
    scale = float(K.spmv_batch_ell_plain(A.col_idx, A.values.abs(), X.abs()).max())
    err = float((y - y_ref).abs().max())
    check(f"spmv_batch_ell{where} at {nb} x {m} x k = {k}, subgroup "
          f"{geo['subgroup']}", err, 8 * k * eps * scale)
    crow = torch.arange(nb * m + 1, device="cuda") * k
    ccol = (torch.arange(nb, device="cuda")[:, None, None] * n
            + A.col_idx.long()[None]).reshape(-1)
    A_bd = torch.sparse_csr_tensor(crow, ccol, A.values.reshape(-1),
                                   size=(nb * m, nb * n))
    Xc = X.reshape(-1, 1)
    return dict(err=err,
                kernel_fn=lambda: K.spmv_batch_ell(A.col_idx, A.values, X, **geo),
                plain_fn=lambda: K.spmv_batch_ell_plain(A.col_idx, A.values, X),
                nbytes=nb * m * k * 4 + m * k * 4 + nb * n * 4 + nb * m * 4,
                flops=2 * nb * m * k,
                library_fn=lambda: torch.sparse.mm(A_bd, Xc))


def held_axpy_norm_rows(torch, ex, X, Y, gen, where: str = "") -> dict:
    """Holds ``axpy_norm_rows(alpha, X, Y)`` against its plain version — Z
    within 2 eps of |alpha x| + |y|, each row's Z.Z against its f64 sum
    within tree_tol of that row — with the binding's launch configuration,
    and returns the rest of its ``kernel_row`` arguments."""
    from repro_torch import kernels as K
    from repro_torch.kernels.axpy_norm.kernel import rows_chunks

    eps = torch.finfo(torch.float32).eps
    nb, n = X.shape
    alpha = torch.randn(nb, generator=gen, device="cuda")
    cfg = ex.launch_config("axpy_norm_rows", {"nb": nb, "n": n, "itemsize": 4})
    geo = dict(block_threads=cfg["block_threads"], grid_blocks=cfg["grid_blocks"])
    z, ss = K.axpy_norm_rows(alpha, X, Y, **geo)
    z_ref = K.axpy_norm_plain(alpha, X, Y)[0]
    z64 = alpha.double()[:, None] * X.double() + Y.double()
    err_z = float((z - z_ref).abs().max())
    check(f"axpy_norm_rows Z{where}", err_z, 2 * eps * float(
        (alpha.abs()[:, None] * X.abs() + Y.abs()).max()))
    err_s_rows = (ss.double() - (z64 * z64).sum(dim=1)).abs()
    worst = float((err_s_rows / tree_tol_rows(z64 * z64)).max())
    say(f"[kernels] axpy_norm_rows Z.Z{where} at {nb} x {n}, "
        f"{rows_chunks(nb, n, **geo)} piece(s) per row: max_abs_err "
        f"{float(err_s_rows.max()):.3e}; largest error {worst:.3f} of its "
        "row's tolerance")
    if not worst <= 1.0:
        fail(f"axpy_norm_rows' norms{where} disagree with their f64 sums")
    return dict(err=max(err_z, float(err_s_rows.max())),
                kernel_fn=lambda: K.axpy_norm_rows(alpha, X, Y, **geo),
                plain_fn=lambda: K.axpy_norm_plain(alpha, X, Y),
                nbytes=3 * nb * n * 4 + 2 * nb * 4, flops=4 * nb * n)


def phase_kernels(torch, A, A_host, P, ex, copy_bw) -> dict:
    """``A_host``: the matrix's host CSR arrays, for the library's CSR SpMV."""
    from repro_torch import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    m, k = A.values.shape
    x = torch.randn(m, generator=gen, device="cuda")
    w = torch.randn(m, generator=gen, device="cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    eps = torch.finfo(torch.float32).eps
    out = {}

    row = functools.partial(kernel_row, torch, flush, copy_bw)

    # spmv_ell — tolerance: 8 k eps relative to max_i sum_j |a_ij x_j|
    cfg = ex.launch_config("spmv_ell", {"m": m, "k": k})
    geo = dict(block_threads=cfg["block_threads"], subgroup=cfg["subgroup"])
    y = K.spmv_ell(A.col_idx, A.values, x, **geo)
    y_ref = K.spmv_ell_plain(A.col_idx, A.values, x)
    scale = float(K.spmv_ell_plain(A.col_idx, A.values.abs(), x.abs()).max())
    err = float((y - y_ref).abs().max())
    check("spmv_ell", err, 8 * k * eps * scale)
    crow = torch.from_numpy(A_host["indptr"]).to("cuda")
    A_csr = torch.sparse_csr_tensor(
        crow, torch.from_numpy(A_host["indices"]).to("cuda"),
        torch.from_numpy(A_host["values"]).to("cuda"), size=A.shape)
    xs = x[:, None]
    ell_bytes = m * k * (4 + 4) + A.shape[1] * 4 + m * 4
    out["spmv_ell"] = row(
        "spmv_ell", "spmv_ell.cu", "src/repro/kernels/spmv_ell/kernel.py:53", err,
        lambda: K.spmv_ell(A.col_idx, A.values, x, **geo),
        lambda: K.spmv_ell_plain(A.col_idx, A.values, x),
        ell_bytes, 2 * m * k,
        lambda: torch.sparse.mm(A_csr, xs))

    # spmv_dot_ell — y as spmv_ell; w.y against the f64 sum, tree_tol
    cfg = ex.launch_config("spmv_dot", {"m": m, "k": k, "itemsize": 4})
    geo_d = dict(block_threads=cfg["block_threads"], subgroup=cfg["subgroup"])
    y, d = K.spmv_dot_ell(A.col_idx, A.values, x, w, **geo_d)
    y_ref = K.spmv_dot_ell_plain(A.col_idx, A.values, x, w)[0]
    wy64 = w.double() * K.spmv_ell_plain(A.col_idx, A.values.double(), x.double())
    err_y = float((y - y_ref).abs().max())
    err_d = float((d.double() - wy64.sum()).abs())
    check("spmv_dot_ell y", err_y, 8 * k * eps * scale)
    check("spmv_dot_ell w.y", err_d, tree_tol(wy64))
    d2 = K.spmv_dot_ell(A.col_idx, A.values, x, w, **geo_d)[1]
    if not bool(d2 == d):
        fail("spmv_dot_ell dot is not deterministic across runs")
    out["spmv_dot_ell"] = row(
        "spmv_dot_ell", "spmv_dot.cu", "src/repro/kernels/spmv_dot/kernel.py:62",
        max(err_y, err_d),
        lambda: K.spmv_dot_ell(A.col_idx, A.values, x, w, **geo_d),
        lambda: K.spmv_dot_ell_plain(A.col_idx, A.values, x, w),
        ell_bytes + m * 4 + 4, 2 * m * k + 2 * m)

    out["axpy_norm"] = row(
        "axpy_norm", "axpy_norm.cu", "src/repro/kernels/axpy_norm/kernel.py:39",
        **held_axpy_norm(torch, ex, x, w))

    # block_jacobi_apply — every storage dtype at the main path's block count
    nb, bs = P.num_blocks, P.block_size
    vp = torch.randn(nb, bs, generator=gen, device="cuda")
    base = torch.cat([t.float() for t in P.inv_blocks])  # main-path blocks, f32
    variants = []
    main_dtype = P.inv_blocks[0].dtype
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        variants.append(row(
            "block_jacobi_apply", "block_jacobi.cu",
            "src/repro/kernels/block_jacobi/kernel.py:36",
            **held_block_jacobi(torch, ex, base.to(dtype), vp)))
        variants[-1]["storage"] = str(dtype).removeprefix("torch.")
    entry = dict(next(v for v in variants if v["storage"] ==
                      str(main_dtype).removeprefix("torch.")))
    entry["storage_variants"] = variants
    out["block_jacobi_apply"] = entry
    return out


def phase_path(torch, A, b):
    from repro_torch import kernels as K
    from repro_torch.core import make_executor
    from repro_torch.precond import block_jacobi
    from repro_torch.solvers import Stop, cg

    stop = Stop(**STOP_KW)
    ex = make_executor("cuda")

    # the counted run: the user's call, block-Jacobi generated inside
    torch.cuda.synchronize()
    K.reset_launch_counts()
    ex.dispatch_log.clear()
    t0 = time.perf_counter()
    res = cg(A, b, M="block_jacobi", precond_opts=PRECOND_OPTS, stop=stop,
             executor=ex)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    launches = K.launch_counts()
    by_storage = dict(K.block_jacobi_apply.launches_by_storage)
    log = dict(ex.dispatch_log)

    k = res.iterations
    say(f"[path] iterations {k}, converged {res.converged}, "
        f"recursive residual {float(res.residual_norm):.4e}, "
        f"time to solution {t_total:.4f} s (block-Jacobi setup and symmetry "
        "probe included)")
    if not res.converged:
        fail("the CUDA solve did not converge")
    x = res.x
    if x.shape != b.shape or not bool(torch.isfinite(x).all()):
        fail("solution has the wrong shape or non-finite values")

    # preconditioner alone (setup) and the loop alone, for time per iteration
    t0 = time.perf_counter()
    P = block_jacobi(A, PRECOND_OPTS["block_size"],
                     adaptive=PRECOND_OPTS["adaptive"], executor=ex)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_loop = cg(A, b, M=P, stop=stop, executor=ex, strict=False)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    if res_loop.iterations != k or not bool(torch.equal(res_loop.x, x)):
        fail("a repeated CUDA solve did not reproduce the first bit for bit")
    classes = len(P.inv_blocks)
    say(f"[path] block-Jacobi setup {t_setup:.4f} s; solve loop {t_loop:.4f} s "
        f"= {t_loop / k * 1e3:.4f} ms per iteration; precision_counts "
        f"{P.precision_counts}; storage {P.storage_bytes} bytes")
    say(f"[path] dispatch log {log}")
    say(f"[path] kernel launches {launches}; block_jacobi_apply by storage "
        f"{by_storage}")

    expected = {
        "spmv_ell": 1,  # the initial residual b - A x0
        "spmv_dot_ell": k,
        "axpy_norm": k,
        "block_jacobi_apply": (k + 1) * classes,  # once per class per apply
    }
    for name, want in expected.items():
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
        if launches[name] != want or log.get(name) != want:
            fail(f"{name}: {launches[name]} launches, {log.get(name)} "
                 f"dispatches, expected {want} for {k} iterations")
    # one apply launch per storage class present, per preconditioner apply
    want_storage = {dtype: k + 1 for dtype, _ in P.precision_counts}
    if by_storage != want_storage:
        fail(f"block_jacobi_apply launches by storage {by_storage}, expected "
             f"{want_storage}")

    # true residual with the plain SpMV in f64.  f32 CG stops on its
    # recursive residual; the true one drifts from it by about
    # eps32 * ||A|| ||x|| per step, so f32 cannot promise much below 1e-5.
    xd = x.double()
    ax = K.spmv_ell_plain(A.col_idx, A.values.double(), xd)
    rel = float((b.double() - ax).norm() / b.double().norm())
    say(f"[path] true relative residual {rel:.4e}")
    if not rel <= 1e-4:
        fail(f"true relative residual {rel} > 1e-4")

    # the same solve in the torch space on the card
    ex_t = make_executor("torch", device="cuda")
    t0 = time.perf_counter()
    res_t = cg(A, b, M="block_jacobi", precond_opts=PRECOND_OPTS, stop=stop,
               executor=ex_t)
    torch.cuda.synchronize()
    t_torch = time.perf_counter() - t0
    dx = float((res_t.x - x).norm() / res_t.x.norm())
    say(f"[path] torch space: iterations {res_t.iterations}, converged "
        f"{res_t.converged}, time to solution {t_torch:.4f} s; relative "
        f"difference of solutions {dx:.3e}")
    if abs(res_t.iterations - k) > 2:
        fail(f"iterations differ: cuda {k}, torch {res_t.iterations}")
    if not dx <= 1e-3:
        fail(f"solutions differ by {dx} > 1e-3 (relative)")
    t0 = time.perf_counter()
    res_tl = cg(A, b, M=P, stop=stop, executor=ex_t, strict=False)
    torch.cuda.synchronize()
    t_torch_loop = time.perf_counter() - t0
    say(f"[path] torch space loop {t_torch_loop:.4f} s = "
        f"{t_torch_loop / res_tl.iterations * 1e3:.4f} ms per iteration")
    profile = phase_profile(torch, A, b, P, ex)
    return launches, by_storage, {"iterations": k, "time_to_solution_s": t_total,
                      "setup_s": t_setup, "loop_s": t_loop,
                      "ms_per_iteration": t_loop / k * 1e3,
                      "precision_counts": P.precision_counts,
                      "true_relative_residual": rel,
                      "torch_space_iterations": res_t.iterations,
                      "torch_space_time_to_solution_s": t_torch,
                      "torch_space_ms_per_iteration":
                          t_torch_loop / res_tl.iterations * 1e3,
                      "profile": profile}


def phase_profile(torch, A, b, P, ex, iters: int = 50,
                  tag: str = "profile") -> dict:
    """Device time by kernel over ``iters`` CG iterations preconditioned by
    ``P`` (torch.profiler), and the device's busy share of the window's wall
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.solvers import Stop, cg

    stop = Stop(max_iters=iters, reduction_factor=1e-30)  # runs all iters
    cg(A, b, M=P, stop=stop, executor=ex, strict=False)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cg(A, b, M=P, stop=stop, executor=ex, strict=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): a PyTorch operator's CPU
    # event also carries its kernels' time and would count it twice
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    say(f"[{tag}] {iters} iterations: wall {wall_us:.0f} us, device busy "
        f"{busy:.0f} us ({busy / wall_us:.1%}); per iteration "
        f"{wall_us / iters:.1f} us wall, {busy / iters:.1f} us device")
    for dev, count, key in rows[:16]:
        say(f"[{tag}]   {dev / iters:9.2f} us/iter  {count:6d} calls  {key[:90]}")
    return {"iterations": iters, "wall_us": wall_us, "device_busy_us": busy,
            "top": [{"name": key[:120], "calls": count, "us": dev}
                    for dev, count, key in rows[:16]]}


class SpanTotals:
    """A tracer for ``repro_torch.observability.trace``: sums the host time
    of spans by name (the registry's dispatch events are not kept)."""

    def __init__(self):
        self.us = collections.Counter()

    def rel_us(self, t: float) -> float:
        return t * 1e6

    def complete(self, name, ts_us, dur_us, cat="span", args=None) -> None:
        if cat != "dispatch":
            self.us[name] += dur_us


def phase_amg(torch, copy_bw):
    """The AMG path: ``amg_check`` on poisson_2d(1024) through the CUDA
    executor (counted), its launch counts against the hierarchy, the true
    residual, the setup split, the loops alone, the same path in the torch
    space on the card, and the kernels held at this path's shapes: spmv_ell
    on every level operator, axpy_norm and block_jacobi_apply at the outer
    CG's and the baseline's operands, the two SpGEMM kernels at level 0."""
    from repro_torch import kernels as K
    from repro_torch.core import make_executor
    from repro_torch.launch.amg_check import run_amg_check
    from repro_torch.observability import trace
    from repro_torch.precond import make_preconditioner
    from repro_torch.solvers import Stop, cg
    from repro_torch.sparse import ops

    ex = make_executor("cuda")
    torch.cuda.synchronize()
    K.reset_launch_counts()
    r = run_amg_check(AMG_N_SIDE, executor=ex, **AMG_KW)
    launches = K.launch_counts()
    by_storage = dict(K.block_jacobi_apply.launches_by_storage)
    if not r.ok:
        fail("AMG-GATE failed on the card")
    M, A, b = r.M, r.A, r.b
    nlev = len(M.levels)  # coarsened levels: num_levels - 1
    k_amg, k_bj = r.amg.iterations, r.block_jacobi.iterations
    say(f"[amg] hierarchy: {M.num_levels} levels; rows/nnz per level "
        + ", ".join(f"{L.A.shape[0]}/{L.A.nnz}" for L in M.levels)
        + f", coarse {M.coarse_A.shape[0]}/{M.coarse_A.nnz}; operator "
        f"complexity {M.operator_complexity:.4f}")
    say(f"[amg] launches by phase {r.launches}")
    say(f"[amg] dispatches by phase {r.dispatches}")

    # launch counts the hierarchy implies: per coarsened level three SpGEMMs
    # (A.T, A.P, R.(AP)) and one transpose (R = P^T); per V(1,1)-cycle five
    # ELL SpMVs per coarsened level (A.x in the pre-sweep, the residual
    # before restriction, R, P, A.x in the post-sweep), one cycle per
    # preconditioner apply and CG applies it k + 1 times; the fused CG body
    # launches axpy_norm once per iteration; block-Jacobi applies once per
    # storage class per apply
    classes = len(r.M_bj.inv_blocks)
    expected = {
        ("amg_setup", "spgemm_expand"): 3 * nlev,
        ("amg_setup", "csr_permute"): nlev,
        ("amg_solve", "spmv_ell"): 5 * nlev * (k_amg + 1),
        ("amg_solve", "axpy_norm"): k_amg,
        ("block_jacobi_solve", "axpy_norm"): k_bj,
        ("block_jacobi_solve", "block_jacobi_apply"): (k_bj + 1) * classes,
    }
    for (ph, name), want in expected.items():
        got = r.launches[ph][name]
        if got != want:
            fail(f"{name} launched {got} times in {ph}, expected {want}")
    for name in ("spgemm_expand", "csr_permute", "spmv_ell", "axpy_norm",
                 "block_jacobi_apply"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the AMG path")
    # the baseline applies each storage class once per preconditioner apply;
    # the AMG hierarchy's Jacobi smoother launches no block_jacobi_apply
    want_storage = {dtype: k_bj + 1 for dtype, _ in r.M_bj.precision_counts}
    say(f"[amg] block_jacobi_apply launches by storage {by_storage}")
    if by_storage != want_storage:
        fail(f"block_jacobi_apply launches by storage {by_storage}, expected "
             f"{want_storage}")

    # true residual of the AMG solution, f64 plain CSR SpMV
    x = r.amg.x
    if x.shape != b.shape or not bool(torch.isfinite(x).all()):
        fail("AMG solution has the wrong shape or non-finite values")
    rows = torch.repeat_interleave(
        torch.arange(A.shape[0], device="cuda"),
        (A.indptr[1:] - A.indptr[:-1]).long())
    ax = torch.zeros(A.shape[0], dtype=torch.float64, device="cuda").index_add_(
        0, rows, A.values.double() * x.double()[A.indices.long()])
    rel = float((b.double() - ax).norm() / b.double().norm())
    say(f"[amg] true relative residual {rel:.4e}")
    if not rel <= 1e-4:
        fail(f"AMG true relative residual {rel} > 1e-4")

    # the loops alone (no symmetry probe) for the time per iteration.  CSR
    # SpMV in the torch space sums rows with index_add_, whose CUDA atomics
    # add in no fixed order, so a repeat may differ in the last bits: it must
    # converge within 2 iterations of the first
    stop = Stop(max_iters=AMG_KW["max_iters"], reduction_factor=AMG_KW["tol"])

    def time_loops(run, exe):
        """(seconds, iterations) of each solve's loop alone."""
        out = {}
        for name, P, res in (("amg", run.M, run.amg),
                             ("block_jacobi", run.M_bj, run.block_jacobi)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = cg(run.A, run.b, stop=stop, M=P, executor=exe, strict=False)
            torch.cuda.synchronize()
            out[name] = (time.perf_counter() - t0, again.iterations)
            if not again.converged or abs(again.iterations - res.iterations) > 2:
                fail(f"a repeated {name} CG solve took {again.iterations} "
                     f"iterations against {res.iterations}")
        return out

    loops = time_loops(r, ex)
    sec = r.seconds
    summary = {
        "levels": M.num_levels,
        "rows": [L.A.shape[0] for L in M.levels] + [M.coarse_A.shape[0]],
        "nnz": [L.A.nnz for L in M.levels] + [M.coarse_A.nnz],
        "operator_complexity": M.operator_complexity,
        "true_relative_residual": rel,
        "seconds": sec,
    }
    for name, res, setup_key, solve_key in (
            ("amg", r.amg, "amg_setup", "amg_solve"),
            ("block_jacobi", r.block_jacobi, "block_jacobi_setup",
             "block_jacobi_solve")):
        k = res.iterations
        tts = sec[setup_key] + sec[solve_key]
        loop_s, loop_k = loops[name]
        summary[name] = {"iterations": k, "converged": res.converged,
                         "time_to_solution_s": tts, "loop_s": loop_s,
                         "ms_per_iteration": loop_s / loop_k * 1e3}
        say(f"[amg] {name}-cg: {k} iterations, converged {res.converged}, "
            f"time to solution {tts:.4f} s (setup {sec[setup_key]:.4f}, solve "
            f"{sec[solve_key]:.4f} with the symmetry probe); loop alone "
            f"{loop_s:.4f} s for {loop_k} iterations = "
            f"{loop_s / loop_k * 1e3:.4f} ms per iteration")

    # the setup split: a second AMG setup under a span tracer
    totals = SpanTotals()
    trace.set_tracer(totals)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        make_preconditioner(A, "amg", executor=ex, cycle=AMG_KW["cycle"],
                            theta=AMG_KW["theta"])
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    finally:
        trace.set_tracer(None)
    us = totals.us
    split = {
        "aggregation": us["amg.aggregate"],
        "structure_passes": us["spgemm.structure"] + us["spgemm.coalesce"]
        + us["sptranspose.structure"],
        "numeric_passes": us["spgemm.numeric"] + us["sptranspose.numeric"],
        "coarse_inverse": us["amg.coarse_solver"],
    }
    split = {key: v / 1e6 for key, v in split.items()}
    split["rest"] = us["amg.setup"] / 1e6 - sum(split.values())
    split["total"] = traced_s
    summary["setup_split_s"] = split
    say(f"[amg] setup split (second setup, host clock, s): "
        + ", ".join(f"{key} {v:.4f}" for key, v in split.items())
        + " — numeric passes are the kernels with their index upload and the "
        "products' download; rest is the ELL mirrors, P's smoothing sum and "
        "host copies")

    # the same path in the torch space on the card: no kernel launches, the
    # same hierarchy bit for bit, iterations within 2, x within 1e-3
    ex_t = make_executor("torch", device="cuda")
    before = K.launch_counts()
    rt = run_amg_check(AMG_N_SIDE, executor=ex_t, **AMG_KW)
    if K.launch_counts() != before:
        fail("the torch space launched a port kernel")
    Mt = rt.M
    def same_csr(X, Y) -> bool:
        return all(torch.equal(getattr(X, f), getattr(Y, f))
                   for f in ("indptr", "indices", "values"))

    if Mt.num_levels != M.num_levels or not all(
            same_csr(getattr(L, f), getattr(Lt, f))
            for L, Lt in zip(M.levels, Mt.levels) for f in ("A", "P", "R")) \
            or not same_csr(M.coarse_A, Mt.coarse_A):
        fail("the torch-space hierarchy differs from the cuda-space one")
    dx = float((rt.amg.x - x).norm() / rt.amg.x.norm())
    say(f"[amg] torch space on the card: hierarchy bitwise equal; amg-cg "
        f"{rt.amg.iterations} iterations (cuda {k_amg}), block_jacobi-cg "
        f"{rt.block_jacobi.iterations} (cuda {k_bj}); relative difference of "
        f"the AMG solutions {dx:.3e}; setup {rt.seconds['amg_setup']:.4f} s, "
        f"AMG solve {rt.seconds['amg_solve']:.4f} s")
    if abs(rt.amg.iterations - k_amg) > 2 or not dx <= 1e-3:
        fail("the torch-space AMG solve disagrees with the cuda-space one")
    loops_t = time_loops(rt, ex_t)
    say("[amg] torch space loops alone: " + ", ".join(
        f"{name} {sec_:.4f} s for {k} iterations = {sec_ / k * 1e3:.4f} ms per "
        f"iteration" for name, (sec_, k) in loops_t.items()))
    summary["torch_space"] = {
        "amg_iterations": rt.amg.iterations,
        "block_jacobi_iterations": rt.block_jacobi.iterations,
        "seconds": rt.seconds, "x_relative_difference": dx,
        "ms_per_iteration": {name: sec_ / k * 1e3
                             for name, (sec_, k) in loops_t.items()}}
    summary["profile"] = phase_profile(torch, A, b, M, ex, iters=k_amg,
                                       tag="profile amg")

    # spmv_ell at every operator the V-cycle applies (A, P, R per level,
    # k from 4 to about 100): against its plain version, tolerance as in
    # phase 3 (8 k eps relative to max_i sum_j |a_ij x_j|)
    eps = torch.finfo(torch.float32).eps
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst = 0.0
    for lvl, L in enumerate(M.levels):
        for name, E in (("A", L.A_op), ("P", L.P_op), ("R", L.R_op)):
            m, k = E.values.shape
            xv = torch.randn(E.shape[1], generator=gen, device="cuda")
            cfg = ex.launch_config("spmv_ell", {"m": m, "k": k})
            y = K.spmv_ell(E.col_idx, E.values, xv, block_threads=cfg["block_threads"],
                           subgroup=cfg["subgroup"])
            y_ref = K.spmv_ell_plain(E.col_idx, E.values, xv)
            sc = float(K.spmv_ell_plain(E.col_idx, E.values.abs(), xv.abs()).max())
            err = float((y - y_ref).abs().max())
            if not err <= 8 * k * eps * sc:
                fail(f"spmv_ell disagrees with its plain version on level {lvl} "
                     f"{name} ({m}x{E.shape[1]}, k = {k}): {err}")
            worst = max(worst, err / sc if sc else err)
    say(f"[kernels] spmv_ell on the {3 * nlev} AMG level operators: largest "
        f"error {worst:.3e} relative to the row magnitudes (each within 8 k eps)")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    row = functools.partial(kernel_row, torch, flush, copy_bw)

    # axpy_norm at the outer CG's vectors (n rows) and block_jacobi_apply at
    # the baseline's blocks, each storage class: as in phase 3
    xv = torch.randn(A.shape[0], generator=gen, device="cuda")
    wv = torch.randn(A.shape[0], generator=gen, device="cuda")
    held = {"axpy_norm": [row(
        "axpy_norm", "axpy_norm.cu", "src/repro/kernels/axpy_norm/kernel.py:39",
        **held_axpy_norm(torch, ex, xv, wv, " (AMG path)"))],
        "block_jacobi_apply": []}
    bs = r.M_bj.block_size
    for inv in r.M_bj.inv_blocks:
        vp = torch.randn(inv.shape[0], bs, generator=gen, device="cuda")
        held["block_jacobi_apply"].append(row(
            "block_jacobi_apply", "block_jacobi.cu",
            "src/repro/kernels/block_jacobi/kernel.py:36",
            **held_block_jacobi(torch, ex, inv, vp, " (AMG path)")))
        held["block_jacobi_apply"][-1]["storage"] = \
            str(inv.dtype).removeprefix("torch.")

    # the two kernels at level 0's shapes: R.(AP) and P^T
    L0 = M.levels[0]
    AP = ops.spgemm(A, L0.P, executor=ex_t)
    _, _, _, idx1, _ = ops._spgemm_expansion(L0.R, AP)
    idx = torch.from_numpy(idx1).cuda()
    a_vals = L0.R.values
    b_pad = torch.cat([AP.values.new_zeros(1), AP.values])
    bt = ex.launch_config("spgemm", {})["block_threads"]
    out = K.spgemm_expand(a_vals, idx, b_pad, block_threads=bt)
    ref = K.spgemm_expand_plain(a_vals, idx, b_pad)
    err = float((out - ref).abs().max())
    say(f"[kernels] spgemm_expand at R.(AP) of level 0: T = {idx.shape[0]}, "
        f"K = {idx.shape[1]}, nnz(AP) = {AP.nnz}; bitwise equal to the plain "
        f"version: {torch.equal(out, ref)}")
    if not torch.equal(out, ref):
        fail(f"spgemm_expand differs from its plain version (max {err})")
    t, kw = idx.shape
    gathered = int(torch.unique(idx).numel()) * 4
    say("[kernels] spgemm_expand library_ms: null — no single PyTorch call "
        "computes the padded (T, K) expansion (a sparse product coalesces)")
    rows_out = {"spgemm_expand": row(
        "spgemm_expand", "spgemm.cu", "src/repro/kernels/spgemm/kernel.py:46",
        err, lambda: K.spgemm_expand(a_vals, idx, b_pad, block_threads=bt),
        lambda: K.spgemm_expand_plain(a_vals, idx, b_pad),
        4 * t + 8 * t * kw + gathered, t * kw)}
    rows_out["spgemm_expand"]["shape"] = {"T": t, "K": kw}

    order_np, _, _ = ops._transpose_structure(L0.P)
    order = torch.from_numpy(order_np.astype("int32")).cuda()
    vals = L0.P.values
    out = K.csr_permute(vals, order, block_threads=bt)
    ref = K.csr_permute_plain(vals, order)
    say(f"[kernels] csr_permute at P^T of level 0: nnz = {order.numel()}; "
        f"bitwise equal to the plain version: {torch.equal(out, ref)}")
    if not torch.equal(out, ref):
        fail("csr_permute differs from its plain version")
    nnz = order.numel()
    rows_out["csr_permute"] = row(
        "csr_permute", "spgemm.cu", "src/repro/kernels/spgemm/kernel.py:92",
        0.0, lambda: K.csr_permute(vals, order, block_threads=bt),
        lambda: K.csr_permute_plain(vals, order), 12 * nnz, 0,
        lambda: torch.index_select(vals, 0, order))
    rows_out["csr_permute"]["shape"] = {"nnz": nnz}
    return launches, by_storage, summary, rows_out, held


def phase_sellp(torch, copy_bw):
    """The SELL-P path: Jacobi-CG on power_law_laplacian(2**21, seed=4) as
    SELL-P through the CUDA executor (counted), then its checks, the torch
    space on the card, the loop's profile, and spmv_sellp held and timed at
    this matrix."""
    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.core import make_executor
    from repro_torch.solvers import Stop, cg, jacobi_preconditioner
    from repro_torch.sparse import gallery, sellp_from_csr_host

    t0 = time.perf_counter()
    ip, ix, v, shape = gallery.power_law_laplacian(SELLP_N, seed=SELLP_SEED)
    t_gallery = time.perf_counter() - t0
    t0 = time.perf_counter()
    A = sellp_from_csr_host(ip, ix, v, shape, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    m = shape[0]
    row_nnz = np.diff(ip)
    ell_entries = m * int(row_nnz.max())
    say(f"[sellp] power_law_laplacian({m}, seed={SELLP_SEED}): {ix.size} "
        f"nonzeros, longest row {int(row_nnz.max())}; gallery {t_gallery:.2f} s, "
        f"SELL-P build {t_build:.2f} s")
    say(f"[sellp] storage: SELL-P {A.nnz} entries ({A.memory_bytes} bytes, C = "
        f"{A.slice_size}, stride {A.stride_factor}, widest slice "
        f"{A.max_slice_cols}); ELL would store {ell_entries} entries "
        f"({ell_entries * 8} bytes)")
    b = torch.from_numpy(np.random.default_rng(SEED).standard_normal(m)
                         .astype(np.float32)).cuda()
    stop = Stop(**STOP_KW)
    ex = make_executor("cuda")

    torch.cuda.synchronize()
    K.reset_launch_counts()
    ex.dispatch_log.clear()
    t0 = time.perf_counter()
    res = cg(A, b, M="jacobi", stop=stop, executor=ex)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    launches = K.launch_counts()
    log = dict(ex.dispatch_log)
    k = res.iterations
    say(f"[sellp] cuda: iterations {k}, converged {res.converged}, time to "
        f"solution {t_total:.4f} s (Jacobi setup and symmetry probe included)")
    say(f"[sellp] kernel launches {launches}; dispatch log {log}")
    if not res.converged:
        fail("the SELL-P CG solve did not converge")
    x = res.x
    if x.shape != b.shape or not bool(torch.isfinite(x).all()):
        fail("SELL-P solution has the wrong shape or non-finite values")
    # SELL-P has no fused SpMV: the unfused loop applies A once for the
    # initial residual and once per iteration; the symmetry probe runs in
    # host numpy and launches nothing
    want = k + 1
    if launches["spmv_sellp"] != want or log.get("spmv_sellp") != want:
        fail(f"spmv_sellp: {launches['spmv_sellp']} launches, "
             f"{log.get('spmv_sellp')} dispatches, expected {want}")
    others = {n: c for n, c in launches.items() if c and n != "spmv_sellp"}
    if others:
        fail(f"the SELL-P path launched other kernels: {others}")

    ax = K.spmv_sellp_plain(A.col_idx, A.values.double(), A.slice_sets,
                            x.double(), m, A.slice_size)
    rel = float((b.double() - ax).norm() / b.double().norm())
    say(f"[sellp] true relative residual {rel:.4e}")
    if not rel <= 1e-4:
        fail(f"SELL-P true relative residual {rel} > 1e-4")

    # the loop alone, twice: the repeat must be bitwise equal (no atomics
    # on the cuda path: spmv_sellp writes each row once)
    P = jacobi_preconditioner(A, executor=ex)
    loops = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = cg(A, b, M=P, stop=stop, executor=ex, strict=False)
        torch.cuda.synchronize()
        loops.append(time.perf_counter() - t0)
        if again.iterations != k or not torch.equal(again.x, x):
            fail("a repeated SELL-P CG solve did not reproduce the first bit "
                 "for bit")
    t_loop = min(loops)
    say(f"[sellp] loop alone {t_loop:.4f} s = {t_loop / k * 1e3:.4f} ms per "
        f"iteration (repeat bitwise equal)")

    ex_t = make_executor("torch", device="cuda")
    t0 = time.perf_counter()
    res_t = cg(A, b, M="jacobi", stop=stop, executor=ex_t)
    torch.cuda.synchronize()
    t_torch = time.perf_counter() - t0
    Pt = jacobi_preconditioner(A, executor=ex_t)
    t0 = time.perf_counter()
    res_tl = cg(A, b, M=Pt, stop=stop, executor=ex_t, strict=False)
    torch.cuda.synchronize()
    t_torch_loop = time.perf_counter() - t0
    dx = float((res_t.x - x).norm() / res_t.x.norm())
    say(f"[sellp] torch space: iterations {res_t.iterations}, time to solution "
        f"{t_torch:.4f} s, loop alone {t_torch_loop:.4f} s = "
        f"{t_torch_loop / res_tl.iterations * 1e3:.4f} ms per iteration; "
        f"relative difference of solutions {dx:.3e}")
    if abs(res_t.iterations - k) > 2 or not dx <= 1e-3:
        fail(f"torch-space SELL-P solve disagrees: {res_t.iterations} "
             f"iterations against {k}, x differs by {dx}")
    profile = phase_profile(torch, A, b, P, ex, iters=k, tag="profile sellp")

    # spmv_sellp at this matrix against its plain version, per row within
    # 2 (w + 1) eps of the row's magnitude (w its slice's width: both sums
    # round at most w times)
    eps = torch.finfo(torch.float32).eps
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    xv = torch.randn(m, generator=gen, device="cuda")
    C = A.slice_size
    cfg = ex.launch_config("spmv_sellp", {"m": m, "slice_size": C, "itemsize": 4})
    geo = dict(block_threads=cfg["block_threads"], wide_cols=cfg["wide_cols"])
    args = (A.col_idx, A.values, A.slice_sets, xv, m, C)
    y = K.spmv_sellp(*args, **geo)
    y_ref = K.spmv_sellp_plain(*args)
    mag = K.spmv_sellp_plain(A.col_idx, A.values.abs(), A.slice_sets,
                             xv.abs(), m, C)
    width = A.slice_cols.repeat_interleave(C)[:m].to(mag.dtype)
    err_rows = (y - y_ref).abs()
    ratio = float((err_rows / (2 * (width + 1) * eps * mag).clamp_min(1e-30)).max())
    err = float(err_rows.max())
    say(f"[kernels] spmv_sellp: max_abs_err {err:.3e}; largest error "
        f"{ratio:.3f} of its row's tolerance")
    if not ratio <= 1.0:
        fail(f"spmv_sellp disagrees with its plain version ({ratio} of the "
             "per-row tolerance)")
    A_csr = torch.sparse_csr_tensor(
        torch.from_numpy(ip.astype(np.int32)).cuda(),
        torch.from_numpy(ix).cuda(), torch.from_numpy(v).cuda(), size=shape)
    xs = xv[:, None]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    total = A.nnz
    row = kernel_row(
        torch, flush, copy_bw, "spmv_sellp", "spmv_sellp.cu",
        "src/repro/kernels/spmv_sellp/kernel.py:67", err,
        lambda: K.spmv_sellp(*args, **geo),
        lambda: K.spmv_sellp_plain(*args),
        total * 8 + A.slice_sets.numel() * 4 + 2 * m * 4, 2 * total,
        lambda: torch.sparse.mm(A_csr, xs))
    row["shape"] = {"m": m, "stored": total, "nnz": int(ix.size),
                    "widest_slice": A.max_slice_cols, **geo}
    summary = {"rows": m, "nnz": int(ix.size), "sellp_entries": total,
               "ell_entries": ell_entries, "iterations": k,
               "time_to_solution_s": t_total, "loop_s": t_loop,
               "ms_per_iteration": t_loop / k * 1e3,
               "true_relative_residual": rel,
               "torch_space_iterations": res_t.iterations,
               "torch_space_time_to_solution_s": t_torch,
               "torch_space_ms_per_iteration":
                   t_torch_loop / res_tl.iterations * 1e3,
               "profile": profile}
    return launches, summary, {"spmv_sellp": row}


def _batch_checks(torch, label, res, xstar, launches, want, res_t):
    """One batched run's checks: every system converged, the error against
    the known solutions, the kernels' launches, and the torch-space run on
    the card (per-system iterations within 1, x within 1e-4)."""
    import numpy as np

    it = res.iterations.cpu().numpy()
    err = float(np.abs(res.x.cpu().numpy() - xstar).max())
    sweeps = int(it.max())
    say(f"[batch] {label}: {res.num_batch} systems, iterations "
        f"{it.min()}/{int(np.median(it))}/{sweeps} (min/median/max), error "
        f"{err:.3e}; launches {({n: c for n, c in launches.items() if c})}")
    if not bool(res.converged.all()):
        fail(f"{label}: not every system converged")
    if not err <= 1e-4:
        fail(f"{label}: error against the known solutions {err} > 1e-4")
    for name, count in want(sweeps).items():
        if launches[name] != count:
            fail(f"{label}: {name} launched {launches[name]} times, expected "
                 f"{count} for {sweeps} sweeps")
    others = {n: c for n, c in launches.items() if c and n not in want(sweeps)}
    if others:
        fail(f"{label}: unexpected kernel launches {others}")
    it_t = res_t.iterations.cpu().numpy()
    dx = float((res_t.x - res.x).abs().max())
    say(f"[batch] {label}, torch space on the card: largest iteration "
        f"difference {int(np.abs(it_t - it).max())}, largest x difference "
        f"{dx:.3e}")
    if np.abs(it_t - it).max() > 1 or not dx <= 1e-4:
        fail(f"{label}: the torch space disagrees with the cuda space")
    return sweeps, err


def _chunked_equal(torch, A, B, M, solver, ex, stop) -> int:
    """Advance the run in 4-sweep chunks and monolithically; fail unless the
    two end bit for bit equal.  Returns the number of chunks."""
    from repro_torch import batch as tb

    thresh = stop.threshold(tb.batch_norm2(B, executor=ex))
    X0 = torch.zeros_like(B)
    if solver == "cg":
        init = lambda: tb.batch_cg_init(A, B, X0, M=M, executor=ex)  # noqa: E731
        adv = functools.partial(tb.batch_cg_advance, A, stop=stop, M=M,
                                executor=ex)
    else:
        init = lambda: tb.batch_bicgstab_init(A, B, X0, executor=ex)  # noqa: E731
        adv = functools.partial(tb.batch_bicgstab_advance, A, stop=stop, M=M,
                                executor=ex)
    mono = adv(init(), thresh)
    state, chunks = init(), 0
    while True:
        nxt = adv(state, thresh, num_sweeps=4)
        if nxt.k == state.k:
            break
        state, chunks = nxt, chunks + 1
    if state.k != mono.k or not all(
            torch.equal(getattr(state, f), getattr(mono, f))
            for f in ("X", "R", "P", "iters", "rnorm")):
        fail(f"batched {solver}: the 4-sweep chunked run differs from the "
             "monolithic one")
    return chunks


def phase_batch(torch, copy_bw):
    """The batched path: batch_solve's CG runs (no preconditioner, Jacobi),
    batch_cg with block-Jacobi and batch_solve's BiCGSTAB run, each counted
    from 0 and checked; then the kernels held and timed at its shapes."""
    from repro_torch import batch as tb
    from repro_torch import kernels as K
    from repro_torch.kernels.axpy_norm.kernel import rows_chunks
    from repro_torch.launch import batch_solve

    launches_total = collections.Counter()
    storage_total = collections.Counter()
    summary = {}

    def counted(fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = K.launch_counts()
        launches_total.update(counts)
        storage_total.update(K.block_jacobi_apply.launches_by_storage)
        return out, counts, seconds

    def torch_space(argv):
        return batch_solve.run(argv + ["--executor", "torch"]).result

    # CG through the entry point, no preconditioner and Jacobi: one SpMV for the
    # initial residual and one per sweep, one fused update per sweep
    cg_want = lambda s: {"spmv_batch_ell": s + 1, "axpy_norm_rows": s}  # noqa: E731
    for precond in ("none", "jacobi"):
        argv = BATCH_ARGS + ["--precond", precond]
        r, counts, seconds = counted(lambda: batch_solve.run(argv))
        if not r.ok or counts != r.launches:
            fail(f"batch_solve {argv} failed or miscounted")
        sweeps, err = _batch_checks(torch, f"cg/{precond}", r.result, r.xstar,
                                    counts, cg_want, torch_space(argv))
        M = (tb.batch_jacobi_preconditioner(r.A, executor=r.executor)
             if precond == "jacobi" else None)
        chunks = _chunked_equal(torch, r.A, r.B, M, "cg", r.executor, r.stop)
        say(f"[batch] cg/{precond}: solve {r.seconds:.4f} s for {sweeps} "
            f"sweeps (whole run {seconds:.4f} s, host build included); "
            f"{chunks} chunks of 4 sweeps bit for bit equal to the monolithic "
            "run")
        summary[f"cg_{precond}"] = {"sweeps": sweeps, "error": err,
                                    "seconds": r.seconds,
                                    "run_seconds": seconds}
    A, B, xstar, ex, stop = r.A, r.B, r.xstar, r.executor, r.stop

    # batch_cg with 8-row block-Jacobi: block_jacobi_apply once per apply
    def bj_solve(exe):
        M = tb.batch_block_jacobi_preconditioner(A, 8, executor=exe)
        return M, tb.batch_cg(A, B, M=M, stop=stop, executor=exe)

    (Mbj, res), counts, seconds = counted(lambda: bj_solve(ex))
    bj_storage = dict(K.block_jacobi_apply.launches_by_storage)
    from repro_torch.core import make_executor
    ex_t = make_executor("torch", device="cuda")
    res_t = bj_solve(ex_t)[1]
    sweeps, err = _batch_checks(
        torch, "cg/block_jacobi", res, xstar, counts,
        lambda s: {"spmv_batch_ell": s + 1, "axpy_norm_rows": s,
                   "block_jacobi_apply": s + 1}, res_t)
    if bj_storage != {"float32": sweeps + 1}:
        fail(f"block_jacobi_apply by storage {bj_storage}, expected "
             f"{{'float32': {sweeps + 1}}}")
    chunks = _chunked_equal(torch, A, B, Mbj, "cg", ex, stop)
    say(f"[batch] cg/block_jacobi: setup and solve {seconds:.4f} s for "
        f"{sweeps} sweeps, {Mbj.precision_counts}; {chunks} chunks bit for "
        "bit equal")
    summary["cg_block_jacobi"] = {"sweeps": sweeps, "error": err,
                                  "seconds": seconds}

    # BiCGSTAB through the entry point: two SpMVs per sweep
    r, counts, seconds = counted(lambda: batch_solve.run(BATCH_BICGSTAB_ARGS))
    if not r.ok or counts != r.launches:
        fail("batch_solve (bicgstab) failed or miscounted")
    sweeps, err = _batch_checks(
        torch, "bicgstab", r.result, r.xstar, counts,
        lambda s: {"spmv_batch_ell": 2 * s + 1, "axpy_norm_rows": s},
        torch_space(BATCH_BICGSTAB_ARGS))
    A_bi = r.A
    chunks = _chunked_equal(torch, r.A, r.B, None, "bicgstab", r.executor,
                            r.stop)
    say(f"[batch] bicgstab: solve {r.seconds:.4f} s for {sweeps} sweeps; "
        f"{chunks} chunks bit for bit equal")
    summary["bicgstab"] = {"sweeps": sweeps, "error": err, "seconds": r.seconds}
    summary["profile"] = phase_batch_profile(torch, A, B, stop, ex)

    # the kernels at this path's shapes
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    nb, m, k = A.values.shape
    n = A.shape[1]
    X = torch.randn(nb, n, generator=gen, device="cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    row = functools.partial(kernel_row, torch, flush, copy_bw)
    rows = {"spmv_batch_ell": row(
        "spmv_batch_ell", "spmv_batch_ell.cu",
        "src/repro/kernels/spmv_batch_ell/kernel.py:51",
        **held_batch_ell(torch, ex, A, X))}
    rows["spmv_batch_ell"]["shape"] = {"nb": nb, "m": m, "k": k}
    # and at the BiCGSTAB run's operator, whose k = n rows take a wider
    # subgroup than the tridiagonal systems' one thread per row
    X_bi = torch.randn(A_bi.values.shape[0], A_bi.shape[1], generator=gen,
                       device="cuda")
    at_bi = row("spmv_batch_ell", "spmv_batch_ell.cu",
                "src/repro/kernels/spmv_batch_ell/kernel.py:51",
                **held_batch_ell(torch, ex, A_bi, X_bi, " (bicgstab)"))
    at_bi["shape"] = dict(zip(("nb", "m", "k"), A_bi.values.shape))
    rows["spmv_batch_ell"]["at_bicgstab_shape"] = at_bi
    rows["spmv_batch_ell"]["max_abs_err"] = max(
        rows["spmv_batch_ell"]["max_abs_err"], at_bi["max_abs_err"])

    # row-batched axpy_norm at the CG runs' (nb, n), where each row is one
    # block, and at (256, 1024), where each row is cut into pieces whose
    # partials a second launch adds
    rows["axpy_norm_rows"] = row(
        "axpy_norm_rows", "axpy_norm.cu",
        "src/repro/kernels/axpy_norm/kernel.py:39",
        **held_axpy_norm_rows(torch, ex, X, B, gen))
    rows["axpy_norm_rows"]["shape"] = {"nb": nb, "n": n}
    cfg = ex.launch_config("axpy_norm_rows", {"nb": 256, "n": 1024, "itemsize": 4})
    if rows_chunks(256, 1024, cfg["block_threads"], cfg["grid_blocks"]) < 2:
        fail("axpy_norm_rows keeps 256 x 1024 rows whole: its piece sum is "
             "not held")
    Xs = torch.randn(256, 1024, generator=gen, device="cuda")
    Ys = torch.randn(256, 1024, generator=gen, device="cuda")
    at_pieces = row("axpy_norm_rows", "axpy_norm.cu",
                    "src/repro/kernels/axpy_norm/kernel.py:39",
                    **held_axpy_norm_rows(torch, ex, Xs, Ys, gen, " (pieces)"))
    at_pieces["shape"] = {"nb": 256, "n": 1024}
    rows["axpy_norm_rows"]["at_row_pieces_shape"] = at_pieces
    rows["axpy_norm_rows"]["max_abs_err"] = max(
        rows["axpy_norm_rows"]["max_abs_err"], at_pieces["max_abs_err"])
    say("[kernels] axpy_norm_rows library_ms: null — no single PyTorch call "
        "writes Z = alpha X + Y and each row's Z.Z (a norm call needs Z first)")

    # block_jacobi_apply at the block-Jacobi run's blocks (f32, 8 x 8)
    inv = Mbj.inv_blocks[0]
    vp = torch.randn(inv.shape[0], inv.shape[1], generator=gen, device="cuda")
    held = {"block_jacobi_apply": [row(
        "block_jacobi_apply", "block_jacobi.cu",
        "src/repro/kernels/block_jacobi/kernel.py:36",
        **held_block_jacobi(torch, ex, inv, vp, " (batch path)"))]}
    held["block_jacobi_apply"][-1]["storage"] = \
        str(inv.dtype).removeprefix("torch.")
    return dict(launches_total), dict(storage_total), summary, rows, held


def phase_batch_profile(torch, A, B, stop, ex) -> dict:
    """Device time by kernel over one batched CG solve (torch.profiler) and
    the device's busy share of its wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import batch as tb

    tb.batch_cg(A, B, stop=stop, executor=ex)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = tb.batch_cg(A, B, stop=stop, executor=ex)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    sweeps = int(res.iterations.max())
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    say(f"[profile batch] batched CG, {sweeps} sweeps: wall {wall_us:.0f} us, "
        f"device busy {busy:.0f} us ({busy / wall_us:.1%}); per sweep "
        f"{wall_us / sweeps:.1f} us wall, {busy / sweeps:.1f} us device")
    for dev, count, key in rows[:12]:
        say(f"[profile batch]   {dev / sweeps:9.2f} us/sweep  {count:6d} calls  "
            f"{key[:90]}")
    return {"sweeps": sweeps, "wall_us": wall_us, "device_busy_us": busy,
            "top": [{"name": key[:120], "calls": count, "us": dev}
                    for dev, count, key in rows[:12]]}


def phase_small_reference(torch) -> None:
    """A small solve in the cuda space against the port's reference space on
    the CPU: iterations within 1, solutions within 1e-4 (relative)."""
    import numpy as np

    from repro_torch.core import make_executor
    from repro_torch.solvers import Stop, cg
    from repro_torch.sparse import ell_from_csr_host, gallery

    ip, ix, v, shape = gallery.poisson_2d(16)
    b = np.random.default_rng(SEED).standard_normal(shape[0]).astype(np.float32)
    stop = Stop(max_iters=500, reduction_factor=1e-6)
    got = cg(ell_from_csr_host(ip, ix, v, shape, device="cuda"),
             torch.from_numpy(b).cuda(), M="block_jacobi", stop=stop,
             precond_opts={"block_size": 8}, executor=make_executor("cuda"))
    want = cg(ell_from_csr_host(ip, ix, v, shape, device="cpu"),
              torch.from_numpy(b), M="block_jacobi", stop=stop,
              precond_opts={"block_size": 8}, executor=make_executor("reference"))
    dx = float((got.x.cpu() - want.x).norm() / want.x.norm())
    say(f"[small] poisson_2d(16): cuda {got.iterations} iterations, reference "
        f"{want.iterations}; relative difference {dx:.3e}")
    if abs(got.iterations - want.iterations) > 1 or not dx <= 1e-4:
        fail("the small cuda solve disagrees with the reference space")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.core import make_executor
    from repro_torch.precond import block_jacobi
    from repro_torch.sparse import ell_from_csr_host, gallery

    t_start = time.perf_counter()
    card = phase_card(torch)
    build_s = phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    ip, ix, v, shape = gallery.poisson_3d(N_SIDE)
    A_host = dict(indptr=ip.astype(np.int32), indices=ix, values=v)
    A = ell_from_csr_host(ip, ix, v, shape, device="cuda")
    b = torch.from_numpy(
        np.random.default_rng(SEED).standard_normal(shape[0]).astype(np.float32)
    ).cuda()
    ex = make_executor("cuda")
    P = block_jacobi(A, PRECOND_OPTS["block_size"],
                     adaptive=PRECOND_OPTS["adaptive"], executor=ex)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    say(f"[setup] poisson_3d({N_SIDE}): {shape[0]} rows, ELL k = "
        f"{A.max_nnz}, {A.memory_bytes} bytes; block-Jacobi "
        f"{P.precision_counts}, {P.storage_bytes} bytes; {setup_s:.2f} s")

    copy_bw = copy_bandwidth(torch)
    rows = phase_kernels(torch, A, A_host, P, ex, copy_bw)
    del P
    launches, by_storage, path = phase_path(torch, A, b)
    phase_small_reference(torch)
    del A, b
    amg_launches, amg_storage, path["amg"], amg_rows, held_amg = phase_amg(
        torch, copy_bw)
    rows.update(amg_rows)
    sellp_launches, path["sellp"], sellp_rows = phase_sellp(torch, copy_bw)
    rows.update(sellp_rows)
    batch_launches, batch_storage, path["batch"], batch_rows, held_batch = \
        phase_batch(torch, copy_bw)
    rows.update(batch_rows)

    # a kernel also held at a later path's shapes: that row, and the larger
    # error (for block_jacobi_apply, in the variant of its storage)
    for key, held in (("at_amg_path_shape", held_amg),
                      ("at_batch_path_shape", held_batch)):
        for name, extra in held.items():
            for e in extra:
                targets = [v for v in rows[name].get("storage_variants", ())
                           if v["storage"] == e.get("storage")] or [rows[name]]
                for t in targets:
                    t[key] = e
                    t["max_abs_err"] = max(t["max_abs_err"], e["max_abs_err"])
    for entry in rows.values():
        variants = entry.get("storage_variants")
        if variants:
            entry["max_abs_err"] = max(v["max_abs_err"] for v in variants)

    # launches: the sum over the four paths' counted runs, and each path's;
    # block_jacobi_apply's storage variants likewise, per storage dtype
    for name, entry in rows.items():
        entry["launches_by_path"] = {"block_jacobi_cg": launches.get(name, 0),
                                     "amg_check": amg_launches[name],
                                     "sellp_cg": sellp_launches[name],
                                     "batch_solve": batch_launches[name]}
        entry["launches"] = sum(entry["launches_by_path"].values())
        for var in entry.get("storage_variants", ()):
            var["launches_by_path"] = {
                "block_jacobi_cg": by_storage.get(var["storage"], 0),
                "amg_check": amg_storage.get(var["storage"], 0),
                "sellp_cg": 0,
                "batch_solve": batch_storage.get(var["storage"], 0)}
            var["launches"] = sum(var["launches_by_path"].values())
    for name, entry in rows.items():
        if entry["launches"] <= 0:
            fail(f"kernel {name} was launched on none of the paths")
    say(json.dumps({"card": card, "build_s": build_s,
                    "copy_gbs": copy_bw / 1e9, "path": path,
                    "total_s": time.perf_counter() - t_start}))
    say(json.dumps({"kernels": list(rows.values())}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
