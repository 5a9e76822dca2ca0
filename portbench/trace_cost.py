"""What the program's tracing costs on one cell, on the card.

    python3 portbench/trace_cost.py --workload p3d256-bjcg-f32 --seed <n> \\
        [--solves 5] [--out trace_cost.json]

Sets the cell up as a run does, then times ``--solves`` solves of the pool
(host clock, synchronised at both ends) in each mode, in this order:

* ``off``: the program's tracing off and no profiler (an untraced run);
* ``tracer``: the program's :class:`Tracer` on (as under ``REPRO_TRACE=1``),
  an event for every dispatch and span;
* ``profiler``: ``torch.profiler`` (CPU and CUDA activity) running, the
  spans and dispatches as host ranges, ``precond.apply`` timed on the
  device;
* ``profiler_no_spans``: the same with ``span()`` and the dispatch ranges
  patched out;
* ``off`` again.

The ``profiler`` mode's trace also gives each span and ``op.*`` range's
count and mean host µs (``ranges_us``).  Then, with both off, the off
path's own cost from ``timeit`` loops (best of
five, less an empty loop): ns per ``span()`` entered and left, and ns per
read of the profiler flag that gates each dispatch.  Prints one JSON
object, the last line, and writes it to ``--out`` when given.
"""

import argparse
import json
import sys
import time
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _time_solves(solver, pool, k: int, first: int) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(k):
        solver.solve(pool[(first + i) % pool.shape[0]])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / k


def _ns(stmt: str, env: dict, number: int = 1_000_000, repeat: int = 5) -> float:
    best = min(timeit.repeat(stmt, globals=env, number=number, repeat=repeat))
    empty = min(timeit.repeat("pass", globals=env, number=number, repeat=repeat))
    return (best - empty) / number * 1e9


def _ranges(prof) -> dict:
    """``{name: [count, mean host us]}`` of the program's spans and
    ``op.*`` ranges in a profile, the most host time first."""
    by = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith("op.") or name in ("solve", "cg.stop_test",
                                              "precond.apply"):
            c = by.setdefault(name, [0, 0.0])
            c[0] += 1
            c[1] += e.duration_ns() * 1e-3
    return {n: [c, t / c] for n, (c, t) in
            sorted(by.items(), key=lambda kv: -kv[1][1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--solves", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness
    from repro_torch.core import registry
    from repro_torch.observability import trace

    c = harness.load_cell(args.workload, ROOT)
    p = harness.setup(c, args.seed, device="cuda", executor=None,
                      sp=harness.Spans(True))
    solver, pool, k = p["solver"], p["pool"], args.solves
    out = {"workload": args.workload, "seed": args.seed, "solves": k,
           "device": torch.cuda.get_device_name(0), "solve_s": {}}
    first = 1

    def run(mode):
        nonlocal first
        out["solve_s"].setdefault(mode, []).append(
            _time_solves(solver, pool, k, first))
        first += k

    run("off")
    trace.enable()
    run("tracer")
    trace.reset()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        run("profiler")
    out["ranges_us"] = _ranges(prof)
    span, host_range = trace.span, trace.host_range
    trace.span = lambda *a, **kw: trace._NULL_SPAN
    trace.host_range = lambda name: trace._NULL_SPAN
    try:
        with profile(activities=acts):
            run("profiler_no_spans")
    finally:
        trace.span, trace.host_range = span, host_range
    run("off")
    off = sum(out["solve_s"]["off"]) / 2
    out["vs_off"] = {m: v[0] / off for m, v in out["solve_s"].items() if m != "off"}

    x = torch.ones(8, device="cuda")
    env = {"span": trace.span, "x": x, "flag": registry._profiler}
    spans = {"span": "with span('precond.apply', device_of=x): pass",
             "span_no_tensor": "with span('cg.stop_test'): pass"}
    out["off_path_ns"] = {k: _ns(v, env) for k, v in spans.items()}
    out["off_path_ns"]["dispatch_gate"] = _ns("flag._is_profiler_enabled", env)
    env["host_range"] = trace.host_range
    spans["host_range"] = "with host_range('op.probe'): pass"
    with profile(activities=acts):
        out["profiled_ns"] = {k: _ns(v, env, number=2000, repeat=3)
                              for k, v in spans.items()}
    trace.reset_device_spans()
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
