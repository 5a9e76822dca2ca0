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
            is also held against the reference space on the CPU.

It then prints one JSON line describing the kernels and, last, the
``{"ok": true, "device": ...}`` line.  It imports nothing of JAX or of the JAX
package.  Without a CUDA device, or without the repository beside it, it
exits non-zero before printing any result.
"""

from __future__ import annotations

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


def tree_tol(terms) -> float:
    """Tolerance of an f32 tree sum of ``terms`` against their sum in f64.

    Each addition rounds by at most u|s| (u = 2^-24), and the roundings act as
    independent (the probabilistic model of Higham and Mary), so the error's
    spread is about u sqrt(sum of s^2 over the tree's nodes / 3).  The nodes
    are those of a balanced pairwise tree, leaves (the f32 terms themselves)
    included; the tolerance is 16 u times that root-sum-square, over 25 times
    the spread.  For the random-sign w.y at m = 2M this is a few hundredths,
    so dropping a typical block partial (128 terms, tens in size) fails."""
    s = terms.double().flatten()
    total = float((s * s).sum())
    while s.numel() > 1:
        if s.numel() % 2:  # pad to even with a zero leaf
            padded = s.new_zeros(s.numel() + 1)
            padded[:-1] = s
            s = padded
        s = s[0::2] + s[1::2]
        total += float((s * s).sum())
    return 16 * 2.0 ** -24 * total ** 0.5


def check(name: str, err: float, tol: float) -> None:
    say(f"[kernels] {name}: max_abs_err {err:.3e} (tolerance {tol:.3e})")
    if not err <= tol:
        fail(f"{name} disagrees with its plain version: {err} > {tol}")


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

    def row(name, src, line, err, kernel_fn, plain_fn, nbytes, flops,
            library_fn=None):
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

    # axpy_norm — z: 2 eps relative to max |alpha x| + |y|; z.z against the
    # f64 sum, tree_tol
    cfg = ex.launch_config("axpy_norm", {"n": m, "itemsize": 4})
    geo_a = dict(block_threads=cfg["block_threads"],
                 grid_blocks=cfg["grid_blocks"])
    alpha = torch.tensor(-0.37, device="cuda")
    z, ss = K.axpy_norm(alpha, x, w, **geo_a)
    z_ref = K.axpy_norm_plain(alpha, x, w)[0]
    z64 = alpha.double() * x.double() + w.double()
    err_z = float((z - z_ref).abs().max())
    err_s = float((ss.double() - (z64 * z64).sum()).abs())
    check("axpy_norm z", err_z, 2 * eps * float((alpha.abs() * x.abs() + w.abs()).max()))
    check("axpy_norm z.z", err_s, tree_tol(z64 * z64))
    out["axpy_norm"] = row(
        "axpy_norm", "axpy_norm.cu", "src/repro/kernels/axpy_norm/kernel.py:39",
        max(err_z, err_s),
        lambda: K.axpy_norm(alpha, x, w, **geo_a),
        lambda: K.axpy_norm_plain(alpha, x, w),
        3 * m * 4 + 4, 4 * m)

    # block_jacobi_apply — every storage dtype at the main path's block count;
    # tolerance: 2 bs eps relative to max_b,i sum_j |inv_bij v_bj|
    nb, bs = P.num_blocks, P.block_size
    vp = torch.randn(nb, bs, generator=gen, device="cuda")
    base = torch.cat([t.float() for t in P.inv_blocks])  # main-path blocks, f32
    cfg = ex.launch_config("block_jacobi", {"nb": nb, "bs": bs})
    bt = cfg["block_threads"]
    variants = []
    main_dtype = P.inv_blocks[0].dtype
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        inv = base.to(dtype)
        inv32 = inv.float()
        yb = K.block_jacobi_apply(inv, vp, block_threads=bt)
        yb_ref = K.block_jacobi_apply_plain(inv, vp)
        err = float((yb - yb_ref).abs().max())
        sc = float(K.block_jacobi_apply_plain(inv32.abs(), vp.abs()).max())
        check(f"block_jacobi_apply[{dtype}]", err, 2 * bs * eps * sc)
        vcol = vp[:, :, None]
        variants.append(row(
            "block_jacobi_apply", "block_jacobi.cu",
            "src/repro/kernels/block_jacobi/kernel.py:36", err,
            lambda inv=inv: K.block_jacobi_apply(inv, vp, block_threads=bt),
            lambda inv=inv: K.block_jacobi_apply_plain(inv, vp),
            nb * bs * bs * inv.element_size() + 2 * nb * bs * 4, 2 * nb * bs * bs,
            lambda inv32=inv32: torch.bmm(inv32, vcol)))
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


def phase_profile(torch, A, b, P, ex, iters: int = 50) -> dict:
    """Device time by kernel over ``iters`` CG iterations of the main path
    (torch.profiler), and the device's busy share of the window's wall time."""
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
    say(f"[profile] {iters} iterations: wall {wall_us:.0f} us, device busy "
        f"{busy:.0f} us ({busy / wall_us:.1%}); per iteration "
        f"{wall_us / iters:.1f} us wall, {busy / iters:.1f} us device")
    for dev, count, key in rows[:16]:
        say(f"[profile]   {dev / iters:9.2f} us/iter  {count:6d} calls  {key[:90]}")
    return {"iterations": iters, "wall_us": wall_us, "device_busy_us": busy,
            "top": [{"name": key[:120], "calls": count, "us": dev}
                    for dev, count, key in rows[:16]]}


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

    for name, entry in rows.items():
        entry["launches"] = launches[name]
        for var in entry.get("storage_variants", ()):
            var["launches"] = by_storage.get(var["storage"], 0)
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
