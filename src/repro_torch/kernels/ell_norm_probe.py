"""Times ``rmsnorm`` and ``spmv_ell`` at every shape their paths run them,
beside their plain versions, one library call each and their bounds.

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
                _fail(f"rmsnorm at {rows} x {d}: off its plain version by "
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
            _fail(f"spmv_ell on {name} (k = {k}) at subgroup {sg}: error "
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
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
    result = {"card": card, "copy_gbs": copy_bw / 1e9,
              "rmsnorm": probe_rmsnorm(timer, copy_bw),
              "spmv_ell": probe_spmv_ell(timer, copy_bw)}
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
