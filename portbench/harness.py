"""One run of one cell: set-up, the measured window, the traced slice, the
check against the reference, and the result line.

The traffic is a closed loop of solves: the configured solver's
``solve(b)`` back to back, each on the next right-hand side of a pool drawn
from ``--seed`` in set-up (cycled if the window outlasts it).  The window
runs for ``--seconds``; every solve that starts in it completes.
``solve_s`` is the window's wall time, from the first solve's call to the
synchronised return of the last, over the solves completed.

With ``--trace 1`` the same window runs untraced, then a slice of whole
solves runs under ``torch.profiler`` and the per-layer metrics are read.
Once the window has closed and the peak memory is read, the program's state
is freed and the reference checks a sample of the window's solves drawn
from the seed.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import math
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from portbench import judge, profiling, spec

#: top-level module names the process may not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def json_safe(v):
    """``v`` with every non-finite float as its text ('inf', 'nan'): the
    result line stays strict JSON."""
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)
    if isinstance(v, dict):
        return {k: json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [json_safe(x) for x in v]
    return v


def resolve(dotted: str):
    mod, _, attr = dotted.rpartition(".")
    return getattr(importlib.import_module(mod), attr)


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def load_cell(cell: str, root: Path = spec.ROOT,
              overrides: Optional[dict] = None) -> dict:
    """The cell's files, with ``overrides`` merged into its configuration,
    traffic and limits (the CPU tests run a cell at a small size so)."""
    bench = spec.load(root)
    c = spec.cell_files(bench, cell, root)
    over = overrides or {}
    for part in ("config", "traffic", "limits"):
        c[part] = _merge(c[part], over.get(part))
    c["bench"] = bench
    c["name"] = cell
    return c


class Spans:
    """Host-clock spans of set-up, each ending after a device synchronise."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.s = {}

    def sync(self):
        if self.on_card:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str):
        self.sync()
        t0 = time.perf_counter()
        yield
        self.sync()
        self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t0


def make_pool(traffic: dict, seed: int, n: int, dev) -> torch.Tensor:
    """The right-hand sides: ``pool`` standard normal vectors from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(int(seed))
    return torch.randn((int(traffic["pool"]), n), generator=g,
                       dtype=judge.DTYPES[traffic["dtype"]], device=dev)


def setup(c: dict, seed: int, *, device: str, executor: Optional[str],
          sp: Spans) -> dict:
    """Build the system under test as a user would: the CUDA context, the
    kernels' library, the inputs, the format, the preconditioner, the
    generated solver, and one warm-up solve of this cell's shapes."""
    cfg, traffic = c["config"], c["traffic"]
    prog = cfg["program"]
    dev = torch.device(device)
    dtype_name = traffic["dtype"]

    from repro_torch.core import make_executor
    from repro_torch.precond import make_preconditioner
    from repro_torch.solvers import Stop

    if sp.on_card:
        with sp.span("context"):
            torch.zeros(1, device=dev)

    ex_kind = executor or prog["executor"]
    if ex_kind == "cuda":
        from repro_torch.kernels import _build
        with sp.span("library"):
            _build.load()  # builds once per checkout, then loads
    ex = make_executor(ex_kind, device=device)

    with sp.span("inputs"):
        ip, ix, vals, shape = c["generator"].generate(cfg["problem"]["params"],
                                                      device=dev)
        vals = vals.astype(np.dtype(dtype_name))
        n = int(shape[0])
        sizes = cfg.get("sizes") or {}
        if "rows" in sizes and (sizes["rows"], sizes["nonzeros"]) != (n, ix.size):
            raise RuntimeError(f"generated {n} rows, {ix.size} nonzeros; the "
                               f"configuration states {sizes}")
        pool = make_pool(traffic, seed, n, dev)
    fmt = prog["format"]
    with sp.span("format"):
        A = resolve(fmt["fn"])(ip, ix, vals, shape, device=dev,
                               **fmt.get("kwargs", {}))
    pc = prog["preconditioner"]
    with sp.span("precond"):
        M = make_preconditioner(A, pc["kind"], executor=ex, **pc.get("opts", {}))
    sol = prog["solver"]
    with sp.span("solver"):
        solver = resolve(sol["class"])(A, stop=Stop(**prog["stop"]), M=M,
                                       executor=ex, **sol.get("opts", {}))
    with sp.span("warmup"):
        solver.solve(pool[0])
    return {"host": (ip, ix, vals, shape), "n": n, "pool": pool,
            "solver": solver, "dev": dev, "dtype": dtype_name}


def _sampler(seed: int, k: int):
    """Reservoir sampling of ``k`` solves, its draws from the seed alone."""
    rng = np.random.default_rng([int(seed), 0x5A17])

    def slot(i: int) -> Optional[int]:
        if i < k:
            return i
        j = int(rng.integers(0, i + 1))
        return j if j < k else None
    return slot


def run_window(p: dict, seconds: float, k_check: int, seed: int, sp: Spans) -> dict:
    """Solves back to back for ``seconds``; keeps a seeded sample of them."""
    solver, pool = p["solver"], p["pool"]
    P = pool.shape[0]
    slot = _sampler(seed, k_check)
    kept = [None] * k_check
    iters, conv = [], []
    sp.sync()
    t0 = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() - t0 < seconds:
        res = solver.solve(pool[i % P])
        iters.append(res.iterations)
        conv.append(res.converged)
        j = slot(i)
        if j is not None:
            kept[j] = (i, res)
        i += 1
    sp.sync()
    wall = time.perf_counter() - t0
    samples = [(idx, pool[idx % P], r.x, r.iterations, r.residual_norm)
               for idx, r in (s for s in kept if s)]
    return {"seconds": wall, "solves": i, "iterations": iters,
            "converged": conv, "samples": samples}


def check(c: dict, host, samples, converged, dtype_name: str, dev) -> dict:
    """The sampled solves against the float64 reference, and the verdict."""
    ref = judge.Reference(c["reference"], host, c["config"], dtype_name, dev)
    per = [{"solve": idx, **judge.sample_numbers(ref, b, x, k, float(rn))}
           for idx, b, x, k, rn in samples]
    numbers = judge.worst(per, sum(1 for ok in converged if not ok))
    correct, checks = judge.verdict(numbers, c["limits"])
    failed = {j for j, ok in enumerate(converged) if not ok}
    for s in per:
        if any(not s[name] <= lim["limit"]
               for name, lim in c["limits"]["numbers"].items() if name in s):
            failed.add(s["solve"])
    return {"ref": ref, "per": per, "numbers": numbers, "correct": correct,
            "checks": checks, "failed": len(failed)}


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             root: Path = spec.ROOT, device: str = "cuda",
             executor: Optional[str] = None, overrides: Optional[dict] = None,
             t_start: Optional[float] = None) -> dict:
    """Run one cell: the result (the last line's object), the set-up split
    and the sampled solves' numbers (for the earlier lines)."""
    t_start = time.perf_counter() if t_start is None else t_start
    c = load_cell(cell, root, overrides)
    on_card = device == "cuda"
    sp = Spans(on_card)
    sp.s["start"] = time.perf_counter() - t_start  # interpreter and imports
    p = setup(c, seed, device=device, executor=executor, sp=sp)
    sp.sync()
    setup_s = time.perf_counter() - t_start

    traffic = c["traffic"]
    w = run_window(p, seconds, int(traffic["check_solves"]), seed, sp)
    tr = None
    if trace:
        pool, solver = p["pool"], p["solver"]
        nxt = iter(range(w["solves"], w["solves"] + 10 ** 6))
        tr = profiling.profile_slice(
            lambda: solver.solve(pool[next(nxt) % pool.shape[0]]),
            float(traffic["profile_min_s"]), on_card)
        del pool, solver
    peak = torch.cuda.max_memory_allocated(p["dev"]) if on_card else 0

    # the program's state is freed before the reference runs
    samples = [(idx, b.clone(), x.clone(), k, float(rn))
               for idx, b, x, k, rn in w.pop("samples")]
    host, dev, n, dtype_name = p["host"], p["dev"], p["n"], p["dtype"]
    del p
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    v = check(c, host, samples, w["converged"], dtype_name, dev)

    ix = host[1]
    problem = {"n": n, "nnz": int(ix.size),
               "s": judge.DTYPES[dtype_name].itemsize, "dtype": dtype_name,
               "precond_storage_bytes": v["ref"].M.storage_bytes,
               "precond_flops": v["ref"].M.flops,
               "precond_classes": v["ref"].M.class_counts}
    ctx = {"spans": sp.s, "setup_s": setup_s, "window": w, "trace": tr,
           "problem": problem,
           "device_kind": torch.cuda.get_device_name(dev) if on_card else None}
    metrics = {}
    for m in spec.metrics_for(c["bench"], cell, trace):
        val = c["metrics"][m["name"]].read(ctx)
        if val is not None:
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": ctx["device_kind"] or "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(v["correct"]), "attempted": w["solves"],
           "failed": v["failed"], "metrics": metrics, "device": dev_info}
    if tr is not None:
        dev_info["busy_s"] = profiling.busy_seconds(tr)
        dev_info["window_s"] = tr["window_s"]
        bd = profiling.breakdown(tr)
        if bd is not None:
            out["breakdown"] = bd
    out["checks"] = v["checks"]
    return {"result": out, "setup_split_s": dict(sp.s), "setup_s": setup_s,
            "samples": v["per"], "problem": problem,
            "uncompared": {k: x for k, x in v["numbers"].items()
                           if k not in v["checks"]}}
