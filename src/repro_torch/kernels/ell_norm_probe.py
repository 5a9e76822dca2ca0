"""Times ``rmsnorm``, ``spmv_ell``, ``spmv_dot_ell`` and ``axpy_norm`` at
every shape their paths run them, beside their plain versions, a library
call where one exists and their bounds.

    PYTHONPATH=src python -m repro_torch.kernels.ell_norm_probe [--out PATH]

``rmsnorm``: bf16 x and an f32 scale at the Zamba2-2.7B serving shapes, the
prefill's 8 x 2,048 = 16,384 rows and a decode step's 8 rows, each at
d = 5,120 (the shared block's norms) and 2,560 (the final norm), with
``F.rms_norm`` (scale cast to bf16) as the library call.

``spmv_ell``: ``poisson_3d(128)`` as ELL (k = 7, block-Jacobi CG's operator)
and the A, P and R operators of every coarsened level of the AMG hierarchy
of ``poisson_2d(1024)`` (V-cycle, theta 0.08, as ``chip_smoke.py``'s phase 5
builds it), each at the tuning spec's geometry and at every walk the kernel
has for its k (``subgroup`` 1, one thread a row, up to the power of two
covering k), with CSR ``torch.sparse.mm`` as the library call; then the
V(1,1) cycle's sum, 3 t(A) + t(P) + t(R) a level (five ELL SpMVs a coarsened
level), at the spec's walk, at each operator's fastest walk and for the
library.

``spmv_dot_ell``: ``poisson_3d(128)`` as ELL (k = 7, the fused SpMV + dot
of block-Jacobi CG), at the spec's walk and at every walk the kernel has
(``subgroup`` 1 to 8), each y also held bitwise against ``spmv_ell``'s at
the same walk where both have it.

``axpy_norm``: the fused z = alpha x + y and z.z at n = 2,097,152 (ELL CG)
and 1,048,576 (the AMG outer CG), beside ``torch.add(y, x, alpha=-0.37)``
as a streaming floor of the same bytes (it does no reduction, so it is no
library equivalent); ``axpy_norm_rows`` at (16,384, 1,024) (the batched
CG's rows) and (256, 1,024) (rows cut into pieces).  For these two kernels
the probe also counts the device kernels one call runs (``torch.profiler``).

``axpy_l2`` (not in the default set): ``axpy_norm`` and ``torch.add`` at
both n, each timed after three ways of leaving the L2: written over (the
default timer's ``flush.zero_()``, which leaves dirty lines that the timed
call must write back), written over and then read over (a sum of a second
128 MiB buffer, which writes those lines back before the window and leaves
clean ones) and warm (no flush); each also by the profiler's kernel time
(CUPTI) after the first two; beside them the time of the event pair with
nothing between (after the first flush).

``loops`` (not in the default set): device time by kernel an iteration
(``torch.profiler``) of the three CG loops that run these kernels most:
block-Jacobi CG on ``poisson_3d(128)`` (``chip_smoke.py``'s phase 4: ELL,
8-row blocks, adaptive storage; 300 iterations), and on
``poisson_2d(1024)`` AMG-CG (V(1,1), theta 0.08; 15 iterations) and the
block-Jacobi baseline (300 iterations), each loop run past its stopping
test for a fixed count after a warm-up solve.

``spmv_batch_ell`` (not in the default set): the batched solves' two
operators, the CG runs' 16,384 tridiagonal systems of 1,024 rows (k = 3)
and BiCGSTAB's 1,024 dense nonsymmetric systems of 64 rows (k = 64), as
``launch.batch_solve.build_batch`` makes them, each at the spec's route and
at every ``subgroup`` the tree's kernel takes (1 to 32; a refused one is
skipped), each held within 8 k eps of max sum |a x| and repeated bit for
bit, with the CUPTI kernel µs beside the event ms and the block-diagonal
CSR ``torch.sparse.mm`` as the library call; the spec's route also at 64,
128 and 256 threads a block, and after a flush that leaves clean L2 lines
(written over, then a 128 MiB buffer read over), by events and CUPTI, and
warm.

``csr_permute`` (not in the default set): the transpose's value shuffle
on every coarsened level's P of the ``poisson_2d(1024)`` AMG hierarchy
(AMG setup's R = P^T), held bitwise against ``values[order]``, at the
spec's block size (and at 128 to 1,024 threads on level 0), with the CUPTI
kernel µs, ``torch.index_select`` as the library call; level 0 also after
a clean-L2 flush and warm, the library call too.

``batch_loop`` (not in the default set): device time by kernel a sweep
(``torch.profiler``) of batched CG without a preconditioner on the
16,384 tridiagonal systems of 1,024 rows (``chip_smoke.py``'s phase 7;
``Stop(500, 1e-6)``, 15 sweeps), after a warm-up solve.

``--kernels`` picks the families (default: the four kernels).  ``--lib PATH`` loads
a library built elsewhere from the same entry points in place of the tree's
own build (``nvcc ... -shared -cudart shared -I <copy> -o X.so status.cu
spmv_ell.cu spmv_dot.cu axpy_norm.cu`` from altered copies of ``csrc/``;
``status.cu spmv_batch_ell.cu spgemm.cu`` for the last two families): the
way to A/B or ablate one part; such a library is timed, not held.

Each time is the median of 30 CUDA-event runs with the L2 flushed before
each (``sellp_probe.device_ms``); each kernel is held against its plain
version with ``chip_smoke.py``'s tolerances and repeated bit for bit.  The
byte bound counts each input read once and the output written once, at the
H100's 3.35 TB/s and at the measured 1 GiB clone rate.  To time another
tree's kernels, run this file by its path with ``PYTHONPATH`` naming that
tree's ``src``.  Prints one JSON object last (also written to ``--out``);
exits non-zero without a CUDA device or when a kernel disagrees (~1 min on
the card, most of it the AMG setup).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


#: set by ``--lib``: a library built from altered sources is timed, not held
_UNCHECKED = False


def _disagree(msg: str) -> None:
    if _UNCHECKED:
        print(f"unchecked (--lib): {msg}", flush=True)
    else:
        _fail(msg)


def _bounds(nbytes: float, copy_bw: float) -> dict:
    from repro_torch.core.params import H100

    return {"bytes": int(nbytes), "bound_ms": nbytes / H100.hbm_bandwidth * 1e3,
            "copy_bound_ms": nbytes / copy_bw * 1e3}


def probe_rmsnorm(timer, copy_bw: float) -> list:
    from repro_torch import kernels as K
    from repro_torch.core import make_executor

    ex = make_executor("cuda")
    gen = torch.Generator(device="cuda").manual_seed(8)
    out = []
    for rows in (16384, 8):
        for d in (5120, 2560):
            x = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
            w = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
            rpb = ex.launch_config("nn_rmsnorm", {"rows": rows, "d": d,
                                                  "itemsize": 2})["rows_per_block"]

            def kern():
                return K.rmsnorm(x, w, 1e-5, rows_per_block=rpb)

            y, ref = kern(), K.rmsnorm_plain(x, w, 1e-5)
            # one bf16 ulp of the result, plus f32 order (chip_smoke.py)
            tol = 2.0 ** -7 * ref.float().abs() + 1e-6
            err = float(((y.float() - ref.float()).abs() - tol).max())
            if err > 0 or not torch.equal(kern(), y):
                _disagree(f"rmsnorm at {rows} x {d}: off its plain version by "
                      f"{err} past the tolerance, or not repeated bit for bit")
            w_lib = w.to(torch.bfloat16)
            entry = {"rows": rows, "d": d,
                     "ms": timer(kern),
                     "plain_ms": timer(lambda: K.rmsnorm_plain(x, w, 1e-5)),
                     "library_ms": timer(lambda: torch.nn.functional.rms_norm(
                         x, (d,), w_lib, 1e-5))}
            entry.update(_bounds(2 * rows * d * 2 + d * 4, copy_bw))
            print(f"[rmsnorm] {rows} x {d}: {entry['ms']:.4f} ms (plain "
                  f"{entry['plain_ms']:.4f}, F.rms_norm {entry['library_ms']:.4f}, "
                  f"bound {entry['bound_ms']:.4f})", flush=True)
            out.append(entry)
    return out


def _ell_entry(timer, copy_bw, name, E, csr, gen, spec_sg, bt) -> dict:
    """One ELL operator at every walk: times, the spec's walk, the library."""
    from repro_torch import kernels as K
    from repro_torch.core import tuning

    m, k = E.values.shape
    x = torch.randn(E.shape[1], generator=gen, device="cuda")
    ref = K.spmv_ell_plain(E.col_idx, E.values, x)
    scale = float(K.spmv_ell_plain(E.col_idx, E.values.abs(), x.abs()).max())
    tol = 8 * k * torch.finfo(torch.float32).eps * scale
    walks = ([1] if k <= 32 else []) + [
        sg for sg in (2, 4, 8, 16, 32) if sg <= max(2, tuning.next_pow2(k))]
    times = {}
    for sg in walks:
        def kern(sg=sg):
            return K.spmv_ell(E.col_idx, E.values, x, block_threads=bt,
                              subgroup=sg)

        y = kern()
        err = float((y - ref).abs().max())
        if not err <= tol or not torch.equal(kern(), y):
            _disagree(f"spmv_ell on {name} (k = {k}) at subgroup {sg}: error "
                  f"{err} > {tol}, or not repeated bit for bit")
        times[sg] = timer(kern)
    indptr, indices = csr.indptr.to(torch.int32), csr.indices.to(torch.int32)
    A_csr = torch.sparse_csr_tensor(indptr, indices, csr.values, size=csr.shape)
    xs = x[:, None]
    entry = {"operator": name, "m": m, "n": E.shape[1], "k": k,
             "nnz": int(csr.values.numel()), "spec_subgroup": spec_sg,
             "ms": times[spec_sg], "walk_ms": times,
             "best_subgroup": min(times, key=times.get),
             "plain_ms": timer(lambda: K.spmv_ell_plain(E.col_idx, E.values, x)),
             "library_ms": timer(lambda: torch.sparse.mm(A_csr, xs))}
    entry.update(_bounds(m * k * 8 + E.shape[1] * 4 + m * 4, copy_bw))
    print(f"[spmv_ell] {name}: {m} x {E.shape[1]}, k = {k}: spec (subgroup "
          f"{spec_sg}) {entry['ms']:.4f} ms; walks " + ", ".join(
              f"{sg}: {t:.4f}" for sg, t in times.items())
          + f"; plain {entry['plain_ms']:.4f}, CSR torch.sparse.mm "
          f"{entry['library_ms']:.4f}, bound {entry['bound_ms']:.4f}", flush=True)
    return entry


def probe_spmv_ell(timer, copy_bw: float) -> dict:
    from repro_torch.core import make_executor
    from repro_torch.precond import make_preconditioner
    from repro_torch.sparse import csr_from_arrays, ell_from_csr_host, gallery

    ex = make_executor("cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)

    def spec(E):
        cfg = ex.launch_config("spmv_ell", {"m": E.values.shape[0],
                                            "k": E.values.shape[1],
                                            "itemsize": 4})
        return cfg["subgroup"], cfg["block_threads"]

    ip, ix, v, shape = gallery.poisson_3d(128)
    E = ell_from_csr_host(ip, ix, v, shape, device="cuda")
    csr = csr_from_arrays(ip, ix, v, shape, device="cuda")
    path = _ell_entry(timer, copy_bw, "poisson_3d(128)", E, csr, gen, *spec(E))
    del E, csr

    ip, ix, v, shape = gallery.poisson_2d(1024)
    A = csr_from_arrays(ip, ix, v, shape, device="cuda")
    M = make_preconditioner(A, "amg", executor=ex, cycle="v", theta=0.08)
    levels = []
    for lvl, L in enumerate(M.levels):
        for name, E, csr in (("A", L.A_op, L.A), ("P", L.P_op, L.P),
                             ("R", L.R_op, L.R)):
            levels.append(_ell_entry(timer, copy_bw, f"level {lvl} {name}", E,
                                     csr, gen, *spec(E)))
            levels[-1]["level"] = lvl
    weight = {"A": 3, "P": 1, "R": 1}  # ELL SpMVs of a V(1,1) cycle a level

    def cycle(key):
        return sum(weight[e["operator"][-1]] * key(e) for e in levels)

    v_cycle = {"spmv_ell_launches": sum(weight[e["operator"][-1]] for e in levels),
               "spec_ms": cycle(lambda e: e["ms"]),
               "best_walk_ms": cycle(lambda e: min(e["walk_ms"].values())),
               "bound_ms": cycle(lambda e: e["bound_ms"]),
               "copy_bound_ms": cycle(lambda e: e["copy_bound_ms"]),
               "plain_ms": cycle(lambda e: e["plain_ms"]),
               "library_ms": cycle(lambda e: e["library_ms"])}
    print("[spmv_ell] V(1,1) cycle: " + ", ".join(
        f"{key} {val:.4f}" for key, val in v_cycle.items()), flush=True)
    return {"path": path, "amg_levels": levels, "v_cycle": v_cycle}


def device_kernels(fn, calls: int = 5) -> list:
    """Names of the device operations (kernels, copies, fills) that
    ``calls`` calls of ``fn`` run, under ``torch.profiler``, after a warm-up
    call.  A short sleep kernel ends the window, so the calls' operations
    are never its last (the profiler can drop the window's last device
    event); it is left out of the list.  A window whose marker or any of
    whose calls went unrecorded is taken again, at most three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda._sleep(1000)  # the marker
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        ops = [name for name in names if "spin_kernel" not in name]
        if len(ops) >= calls and len(ops) < len(names):
            break
    return ops


def probe_spmv_dot(timer, copy_bw: float) -> dict:
    """``spmv_dot_ell`` at ``poisson_3d(128)`` per walk (see the docstring)."""
    from repro_torch import kernels as K
    from repro_torch.core import make_executor
    from repro_torch.sparse import ell_from_csr_host, gallery

    ex = make_executor("cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    E = ell_from_csr_host(*gallery.poisson_3d(128), device="cuda")
    m, k = E.values.shape
    x = torch.randn(E.shape[1], generator=gen, device="cuda")
    w = torch.randn(m, generator=gen, device="cuda")
    cfg = ex.launch_config("spmv_dot", {"m": m, "k": k, "itemsize": 4})
    spec = {p: cfg[p] for p in cfg.block}
    ref = K.spmv_ell_plain(E.col_idx, E.values, x)
    scale = float(K.spmv_ell_plain(E.col_idx, E.values.abs(), x.abs()).max())
    tol_y = 8 * k * torch.finfo(torch.float32).eps * scale
    wy = (w.double() * ref.double())
    tol_d = 16 * 2.0 ** -24 * float(wy.abs().sum())
    walks = {f"subgroup {sg}": {"block_threads": 256, "subgroup": sg}
             for sg in (1, 2, 4, 8)}
    walks["spec"] = spec
    times, launches = {}, {}
    for label, geo in walks.items():
        def kern(geo=geo):
            return K.spmv_dot_ell(E.col_idx, E.values, x, w, **geo)

        y, d = kern()
        err_y = float((y - ref).abs().max())
        err_d = abs(float(d) - float(wy.sum()))
        y2, d2 = kern()
        if not (err_y <= tol_y and err_d <= tol_d and torch.equal(y2, y)
                and torch.equal(d2, d)):
            _disagree(f"spmv_dot_ell at {label}: y error {err_y} (> {tol_y}?), "
                  f"dot error {err_d} (> {tol_d}?), or not repeated bit for bit")
        ell_geo = {p: geo[p] for p in ("block_threads", "subgroup")}
        same = (torch.equal(y, K.spmv_ell(E.col_idx, E.values, x, **ell_geo))
                if geo["subgroup"] > 1 or k <= 32 else None)
        times[label] = timer(kern)
        launches[label] = len(device_kernels(kern)) / 5
        print(f"[spmv_dot_ell] {label} {geo}: {times[label]:.4f} ms, "
              f"{launches[label]} device kernel(s) a call, y bitwise "
              f"spmv_ell's: {same}", flush=True)
    entry = {"operator": "poisson_3d(128)", "m": m, "k": k, "spec": spec,
             "ms": times["spec"], "walk_ms": times,
             "device_kernels": launches,
             "plain_ms": timer(lambda: K.spmv_dot_ell_plain(E.col_idx, E.values,
                                                            x, w))}
    entry.update(_bounds(m * k * 8 + E.shape[1] * 4 + 2 * m * 4 + 4, copy_bw))
    print(f"[spmv_dot_ell] spec {spec}: {entry['ms']:.4f} ms (plain "
          f"{entry['plain_ms']:.4f}, bound {entry['bound_ms']:.4f})", flush=True)
    return entry


def probe_axpy_norm(timer, copy_bw: float) -> dict:
    """``axpy_norm`` at both CG paths' n and ``axpy_norm_rows`` at the batched
    solves' shapes, each at the spec's geometry."""
    from repro_torch import kernels as K
    from repro_torch.core import make_executor

    ex = make_executor("cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {"vector": [], "rows": []}
    alpha = torch.tensor(-0.37, device="cuda")
    for n in (2_097_152, 1_048_576):
        x = torch.randn(n, generator=gen, device="cuda")
        y = torch.randn(n, generator=gen, device="cuda")
        cfg = ex.launch_config("axpy_norm", {"n": n, "itemsize": 4})
        geo = {p: cfg[p] for p in cfg.block}

        def kern():
            return K.axpy_norm(alpha, x, y, **geo)

        z, ss = kern()
        z64 = alpha.double() * x.double() + y.double()
        err_z = float((z.double() - z64).abs().max())
        err_s = abs(float(ss) - float((z64 * z64).sum()))
        tol_s = 16 * 2.0 ** -24 * float((z64 * z64).sum())
        if not (err_z <= 2 * 2.0 ** -23 * float(z64.abs().max() + 1)
                and err_s <= tol_s and torch.equal(kern()[1], ss)):
            _disagree(f"axpy_norm at n = {n}: z error {err_z}, z.z error {err_s} "
                  f"(> {tol_s}?), or not repeated bit for bit")
        entry = {"n": n, "geometry": geo, "ms": timer(kern),
                 "device_kernels": len(device_kernels(kern)) / 5,
                 "plain_ms": timer(lambda: K.axpy_norm_plain(alpha, x, y)),
                 "torch_add_ms": timer(lambda: torch.add(y, x, alpha=-0.37))}
        entry.update(_bounds(3 * n * 4 + 8, copy_bw))
        print(f"[axpy_norm] n = {n} {geo}: {entry['ms']:.4f} ms, "
              f"{entry['device_kernels']} device kernel(s) a call (plain "
              f"{entry['plain_ms']:.4f}, torch.add floor "
              f"{entry['torch_add_ms']:.4f}, bound {entry['bound_ms']:.4f})",
              flush=True)
        out["vector"].append(entry)
    for nb, n in ((16_384, 1_024), (256, 1_024)):
        X = torch.randn(nb, n, generator=gen, device="cuda")
        Y = torch.randn(nb, n, generator=gen, device="cuda")
        a = torch.randn(nb, generator=gen, device="cuda")
        cfg = ex.launch_config("axpy_norm_rows", {"nb": nb, "n": n, "itemsize": 4})
        geo = {p: cfg[p] for p in cfg.block}

        def kern():
            return K.axpy_norm_rows(a, X, Y, **geo)

        z, ss = kern()
        z64 = a.double()[:, None] * X.double() + Y.double()
        s64 = (z64 * z64).sum(dim=1)
        err_s = float(((ss.double() - s64).abs() / s64).max())
        if not (err_s <= 16 * 2.0 ** -24 and torch.equal(kern()[1], ss)):
            _disagree(f"axpy_norm_rows at {nb} x {n}: relative z.z error {err_s}, "
                  "or not repeated bit for bit")
        entry = {"nb": nb, "n": n, "geometry": geo, "ms": timer(kern),
                 "device_kernels": len(device_kernels(kern)) / 5,
                 "plain_ms": timer(lambda: K.axpy_norm_plain(a, X, Y))}
        entry.update(_bounds(3 * nb * n * 4 + 2 * nb * 4, copy_bw))
        print(f"[axpy_norm_rows] {nb} x {n} {geo}: {entry['ms']:.4f} ms, "
              f"{entry['device_kernels']} device kernel(s) a call (plain "
              f"{entry['plain_ms']:.4f}, bound {entry['bound_ms']:.4f})",
              flush=True)
        out["rows"].append(entry)
    return out


def _timed(fn, before, reps: int = 30) -> float:
    """Median CUDA-event ms of ``fn`` with ``before()`` run (untimed) ahead
    of each run; a sleep kernel holds the stream while the host enqueues."""
    import statistics

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for st, en in zip(starts, ends):
        before()
        st.record()
        fn()
        en.record()
    torch.cuda.synchronize()
    return statistics.median(st.elapsed_time(en) for st, en in zip(starts, ends))


def _kernel_us(fn, before, reps: int = 30) -> float:
    """Median device time in µs of ``fn``'s own kernels (CUPTI, through
    ``torch.profiler``) with ``before()`` run ahead of each call."""
    import statistics

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = set(device_kernels(fn, calls=3))
    before()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            before()
            fn()
        torch.cuda.synchronize()
    durs = [e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == DeviceType.CUDA and e.name in names]
    return statistics.median(durs) if durs else float("nan")


def probe_axpy_l2(timer, copy_bw: float) -> dict:
    """Where ``axpy_norm``'s and ``torch.add``'s time over their byte bound
    goes after the flush (see the docstring)."""
    from repro_torch import kernels as K
    from repro_torch.core import make_executor

    ex = make_executor("cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    alpha = torch.tensor(-0.37, device="cuda")
    dirty = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    clean = torch.ones(128 << 20, dtype=torch.uint8, device="cuda")

    def write_flush():
        dirty.zero_()

    def read_flush():
        dirty.zero_()
        clean.sum()

    modes = {"written": write_flush, "written_then_read": read_flush,
             "warm": lambda: None}
    out = []
    for n in (2_097_152, 1_048_576):
        x = torch.randn(n, generator=gen, device="cuda")
        y = torch.randn(n, generator=gen, device="cuda")
        cfg = ex.launch_config("axpy_norm", {"n": n, "itemsize": 4})
        geo = {p: cfg[p] for p in cfg.block}
        fns = {"axpy_norm": lambda: K.axpy_norm(alpha, x, y, **geo),
               "torch_add": lambda: torch.add(y, x, alpha=-0.37)}
        entry = {"n": n, **_bounds(3 * n * 4 + 8, copy_bw),
                 # the event pair with nothing between: the window's own cost
                 "empty_window_ms": _timed(lambda: None, write_flush)}
        for name, fn in fns.items():
            entry[name] = {f"{mode}_ms": _timed(fn, before)
                           for mode, before in modes.items()}
            for mode in ("written", "written_then_read"):
                entry[name][f"{mode}_kernel_us"] = _kernel_us(fn, modes[mode])
            print(f"[axpy_l2] n = {n} {name}: " + ", ".join(
                f"{key} {val:.4f}" for key, val in entry[name].items())
                + f" (bound {entry['bound_ms']:.4f} ms, empty event window "
                f"{entry['empty_window_ms']:.4f} ms)", flush=True)
        out.append(entry)
    return out


def _loop_profile(A, b, P, ex, iters: int) -> dict:
    """Device µs by kernel an iteration over ``iters`` CG iterations, after a
    warm-up solve of the same count."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.solvers import Stop, cg

    stop = Stop(max_iters=iters, reduction_factor=1e-30)  # runs all iters
    cg(A, b, M=P, stop=stop, executor=ex, strict=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cg(A, b, M=P, stop=stop, executor=ex, strict=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    return {"iterations": iters, "wall_us_per_iteration": wall_us / iters,
            "device_us_per_iteration": busy / iters,
            "kernels": [{"name": key[:120], "calls_per_iteration": count / iters,
                         "us_per_iteration": dev / iters}
                        for dev, count, key in rows]}


def probe_loops(timer, copy_bw: float) -> dict:
    """Device time by kernel an iteration of the CG loops (see the
    docstring)."""
    import numpy as np

    from repro_torch.core import make_executor
    from repro_torch.precond import block_jacobi, make_preconditioner
    from repro_torch.sparse import csr_from_arrays, ell_from_csr_host, gallery

    ex = make_executor("cuda")
    out = {}
    ip, ix, v, shape = gallery.poisson_3d(128)
    A = ell_from_csr_host(ip, ix, v, shape, device="cuda")
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(shape[0])
                         .astype(np.float32)).cuda()
    P = block_jacobi(A, 8, adaptive=True, executor=ex)
    out["ell_block_jacobi"] = _loop_profile(A, b, P, ex, 300)
    del A, b, P
    ip, ix, v, shape = gallery.poisson_2d(1024)
    A = csr_from_arrays(ip, ix, v, shape, device="cuda")
    b = torch.from_numpy(np.random.default_rng(0).normal(size=shape[0])
                         .astype(np.float32)).cuda()
    M = make_preconditioner(A, "amg", executor=ex, cycle="v", theta=0.08)
    out["amg_cg"] = _loop_profile(A, b, M, ex, 15)
    del M
    M_bj = make_preconditioner(A, "block_jacobi", executor=ex)
    out["amg_baseline_block_jacobi"] = _loop_profile(A, b, M_bj, ex, 300)
    for name, prof in out.items():
        print(f"[loops] {name}: {prof['device_us_per_iteration']:.2f} us of "
              f"device time an iteration, {prof['wall_us_per_iteration']:.1f} "
              "us of wall", flush=True)
        for row in prof["kernels"][:14]:
            print(f"[loops]   {row['us_per_iteration']:9.3f} us/iter "
                  f"{row['calls_per_iteration']:6.2f} calls/iter  "
                  f"{row['name'][:90]}", flush=True)
    return out


def _clean_l2(dirty, fn) -> dict:
    """``fn`` timed after a flush that leaves clean L2 lines (``dirty`` written
    over, then a 128 MiB buffer read over, so the timed call writes back no
    flush line), by events and by its kernels' CUPTI time, and warm (no
    flush); beside the empty event pair after the default (written) flush."""
    clean = torch.ones(128 << 20, dtype=torch.uint8, device="cuda")

    def read_flush():
        dirty.zero_()
        clean.sum()

    return {"clean_ms": _timed(fn, read_flush),
            "clean_kernel_us": _kernel_us(fn, read_flush),
            "warm_ms": _timed(fn, lambda: None),
            "empty_window_ms": _timed(lambda: None, dirty.zero_)}


def _batch_ell_entry(timer, copy_bw, label, A, X, ex, dirty) -> dict:
    """``spmv_batch_ell`` on the BatchEll ``A`` at every route it takes (see
    the docstring): event ms and CUPTI kernel µs, the plain version and the
    block-diagonal CSR ``torch.sparse.mm``."""
    from repro_torch import kernels as K

    nb, m, k = A.values.shape
    n = A.shape[1]
    size = A.values.element_size()
    cfg = ex.launch_config("spmv_batch_ell", {"nb": nb, "m": m, "k": k, "n": n,
                                              "itemsize": size})
    spec = {"block_threads": cfg["block_threads"], "subgroup": cfg["subgroup"]}
    ref = K.spmv_batch_ell_plain(A.col_idx, A.values, X)
    scale = float(K.spmv_batch_ell_plain(A.col_idx, A.values.abs(), X.abs()).max())
    tol = 8 * k * torch.finfo(A.values.dtype).eps * scale
    walks, kernel_us = {}, {}
    for sg in (1, 2, 4, 8, 16, 32):
        geo = {"block_threads": spec["block_threads"], "subgroup": sg}

        def kern(geo=geo):
            return K.spmv_batch_ell(A.col_idx, A.values, X, **geo)

        try:
            y = kern()
        except ValueError as exc:  # a route this tree's kernel does not take
            print(f"[spmv_batch_ell] {label} subgroup {sg}: refused ({exc})",
                  flush=True)
            continue
        err = float((y - ref).abs().max())
        if not err <= tol or not torch.equal(kern(), y):
            _disagree(f"spmv_batch_ell {label} at subgroup {sg}: error {err} "
                      f"> {tol}, or not repeated bit for bit")
        walks[sg] = timer(kern)
        kernel_us[sg] = _kernel_us(kern, dirty.zero_)
    block_ms = {}  # the spec's route at other block sizes
    for bt in (64, 128, 256):
        block_ms[bt] = timer(lambda bt=bt: K.spmv_batch_ell(
            A.col_idx, A.values, X, block_threads=bt,
            subgroup=spec["subgroup"]))
    crow = torch.arange(nb * m + 1, device="cuda") * k
    ccol = (torch.arange(nb, device="cuda")[:, None, None] * n
            + A.col_idx.long()[None]).reshape(-1)
    A_bd = torch.sparse_csr_tensor(crow, ccol, A.values.reshape(-1),
                                   size=(nb * m, nb * n))
    Xc = X.reshape(-1, 1)
    entry = {"shape": label, "block_ms": block_ms, "nb": nb, "m": m, "n": n, "k": k, "spec": spec,
             "ms": walks[spec["subgroup"]],
             "kernel_us": kernel_us[spec["subgroup"]],
             "walk_ms": walks, "walk_kernel_us": kernel_us,
             "plain_ms": timer(lambda: K.spmv_batch_ell_plain(A.col_idx,
                                                              A.values, X)),
             "library_ms": timer(lambda: torch.sparse.mm(A_bd, Xc))}
    entry.update(_bounds(nb * m * k * size + m * k * 4 + nb * (n + m) * size,
                         copy_bw))
    entry.update(_clean_l2(dirty, lambda: K.spmv_batch_ell(A.col_idx, A.values,
                                                           X, **spec)))
    print(f"[spmv_batch_ell] {label} {nb} x {m}, k = {k}: spec {spec} "
          f"{entry['ms']:.4f} ms ({entry['kernel_us']:.2f} us kernel); walks "
          + ", ".join(f"{sg}: {t:.4f} / {kernel_us[sg]:.2f} us"
                      for sg, t in walks.items())
          + "; spec route by block " + ", ".join(
              f"{bt}: {t:.4f}" for bt, t in block_ms.items())
          + f"; plain {entry['plain_ms']:.4f}, block-diagonal CSR "
          f"torch.sparse.mm {entry['library_ms']:.4f}, bound "
          f"{entry['bound_ms']:.4f}; clean L2 {entry['clean_ms']:.4f} ms "
          f"({entry['clean_kernel_us']:.2f} us kernel), warm "
          f"{entry['warm_ms']:.4f}, empty window {entry['empty_window_ms']:.4f}",
          flush=True)
    return entry


def probe_spmv_batch_ell(timer, copy_bw: float) -> list:
    """``spmv_batch_ell`` at the batched solves' two operators (see the
    docstring)."""
    from repro_torch.core import make_executor
    from repro_torch.launch.batch_solve import build_batch

    ex = make_executor("cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    dirty = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    out = []
    for label, nb, n, nonsym in (("cg", 16_384, 1_024, False),
                                 ("bicgstab", 1_024, 64, True)):
        A, _, _ = build_batch(nb, n, fmt="ell", nonsym=nonsym, device="cuda")
        X = torch.randn(nb, n, generator=gen, device="cuda")
        out.append(_batch_ell_entry(timer, copy_bw, label, A, X, ex, dirty))
        del A, X
    return out


def probe_csr_permute(timer, copy_bw: float) -> list:
    """``csr_permute`` on the transpose of every AMG level's P (see the
    docstring)."""
    from repro_torch import kernels as K
    from repro_torch.core import make_executor
    from repro_torch.precond import make_preconditioner
    from repro_torch.sparse import csr_from_arrays, gallery, ops

    ex = make_executor("cuda")
    dirty = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    ip, ix, v, shape = gallery.poisson_2d(1024)
    A = csr_from_arrays(ip, ix, v, shape, device="cuda")
    M = make_preconditioner(A, "amg", executor=ex, cycle="v", theta=0.08)
    out = []
    for lvl, L in enumerate(M.levels):
        order_np, _, _ = ops._transpose_structure(L.P)
        order = torch.from_numpy(order_np.astype("int32")).cuda()
        vals = L.P.values
        nnz = order.numel()
        bt = ex.launch_config("spgemm", {"nnz_a": nnz})["block_threads"]
        blocks = (128, 256, 512, 1024) if lvl == 0 else (bt,)
        times, kernel_us = {}, {}
        for threads in blocks:
            def kern(threads=threads):
                return K.csr_permute(vals, order, block_threads=threads)

            if not torch.equal(kern(), K.csr_permute_plain(vals, order)):
                _disagree(f"csr_permute on level {lvl}'s P^T at {threads} "
                          "threads differs from values[order]")
            times[threads] = timer(kern)
            kernel_us[threads] = _kernel_us(kern, dirty.zero_)
        entry = {"level": lvl, "nnz": nnz, "spec_block_threads": bt,
                 "ms": times[bt], "kernel_us": kernel_us[bt],
                 "block_ms": times, "block_kernel_us": kernel_us,
                 "plain_ms": timer(lambda: K.csr_permute_plain(vals, order)),
                 "library_ms": timer(lambda: torch.index_select(vals, 0, order)),
                 "library_kernel_us": _kernel_us(
                     lambda: torch.index_select(vals, 0, order), dirty.zero_)}
        entry.update(_bounds(nnz * (4 + 2 * vals.element_size()), copy_bw))
        if lvl == 0:
            entry.update(_clean_l2(dirty, lambda: K.csr_permute(
                vals, order, block_threads=bt)))
            entry["library_clean"] = _clean_l2(
                dirty, lambda: torch.index_select(vals, 0, order))
        print(f"[csr_permute] level {lvl} P^T, nnz = {nnz}: {entry['ms']:.4f} ms "
              f"({entry['kernel_us']:.2f} us kernel) at {bt} threads; by block "
              + ", ".join(f"{b}: {t:.4f} / {kernel_us[b]:.2f} us"
                          for b, t in times.items())
              + f"; plain {entry['plain_ms']:.4f}, torch.index_select "
              f"{entry['library_ms']:.4f} ({entry['library_kernel_us']:.2f} us), "
              f"bound {entry['bound_ms']:.4f}", flush=True)
        if lvl == 0:
            print(f"[csr_permute] level 0, clean L2: {entry['clean_ms']:.4f} ms "
                  f"({entry['clean_kernel_us']:.2f} us kernel), warm "
                  f"{entry['warm_ms']:.4f}; torch.index_select "
                  + ", ".join(f"{key} {val:.4f}" for key, val
                              in entry["library_clean"].items()), flush=True)
        out.append(entry)
    return out


def probe_batch_loop(timer, copy_bw: float) -> dict:
    """Device time by kernel a sweep of batched CG (see the docstring)."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import batch as tb
    from repro_torch.core import make_executor
    from repro_torch.launch.batch_solve import build_batch
    from repro_torch.solvers import Stop

    ex = make_executor("cuda")
    A, B, _ = build_batch(16_384, 1_024, fmt="ell", device="cuda")
    stop = Stop(max_iters=500, reduction_factor=1e-6)
    tb.batch_cg(A, B, stop=stop, executor=ex)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = tb.batch_cg(A, B, stop=stop, executor=ex)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    sweeps = int(res.iterations.max())
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    out = {"sweeps": sweeps, "wall_us_per_sweep": wall_us / sweeps,
           "device_us_per_sweep": busy / sweeps,
           "kernels": [{"name": key[:120], "calls_per_sweep": count / sweeps,
                        "us_per_sweep": dev / sweeps}
                       for dev, count, key in rows]}
    print(f"[batch_loop] batched CG, {sweeps} sweeps: "
          f"{out['device_us_per_sweep']:.2f} us of device time a sweep, "
          f"{out['wall_us_per_sweep']:.1f} us of wall", flush=True)
    for row in out["kernels"][:8]:
        print(f"[batch_loop]   {row['us_per_sweep']:9.3f} us/sweep "
              f"{row['calls_per_sweep']:6.2f} calls/sweep  {row['name'][:90]}",
              flush=True)
    return out


PROBES = {"rmsnorm": probe_rmsnorm, "spmv_ell": probe_spmv_ell,
          "spmv_dot_ell": probe_spmv_dot, "axpy_norm": probe_axpy_norm,
          "axpy_l2": probe_axpy_l2, "loops": probe_loops,
          "spmv_batch_ell": probe_spmv_batch_ell,
          "csr_permute": probe_csr_permute, "batch_loop": probe_batch_loop}
DEFAULT = ("rmsnorm", "spmv_ell", "spmv_dot_ell", "axpy_norm")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--kernels", default=",".join(DEFAULT),
                    help="comma-separated families to time, of "
                         f"{', '.join(PROBES)} (default: the first four)")
    ap.add_argument("--lib", default=None,
                    help="time a library built elsewhere from the same entry "
                         "points (an altered copy of csrc/), unchecked")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if args.lib:
        import ctypes

        from repro_torch.kernels import _build

        global _UNCHECKED
        _UNCHECKED = True
        _build._LIB = ctypes.CDLL(args.lib)
        _build._LIB.repro_error_string.argtypes = [ctypes.c_int]
        _build._LIB.repro_error_string.restype = ctypes.c_char_p
    from repro_torch.kernels.sellp_probe import device_ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def timer(fn):
        return device_ms(fn, flush)

    src = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    copy_bw = 2 * (1 << 30) / (timer(lambda: src.clone()) * 1e-3)
    del src
    result = {"card": card, "lib": args.lib, "copy_gbs": copy_bw / 1e9}
    for name in args.kernels.split(","):
        result[name] = PROBES[name](timer, copy_bw)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
