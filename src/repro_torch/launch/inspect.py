"""Inspect observability artifacts: traces, metrics, convergence histories.

The port of ``repro/launch/inspect.py``, the read side of
:mod:`repro_torch.observability`: a small CLI that turns the artifacts the
instrumented code writes into terminal-sized answers.

* ``trace <file>``    — summarize a Chrome trace: span table + the dispatch
  events' count and host time per op x space x target (the JAX command
  adds bytes and GB/s, which a host time cannot give: no dispatch
  synchronises the card);
* ``validate <file>`` — schema-check a trace file (the CI gate); exit 1 and
  print every problem when invalid;
* ``metrics <file>``  — render an exported metrics JSONL as an aligned table;
* ``solve``           — run a demo Krylov solve with ``history=`` telemetry
  on and plot the per-iteration residual norms as a text sparkline (also a
  one-command way to produce trace + metrics artifacts: ``--trace`` /
  ``--metrics``).  It runs on the card through the CUDA executor unless
  ``--device cpu`` (with ``--executor torch`` or ``reference``) asks for
  the CPU.

The text of ``metrics``, and the span table of ``trace``, is the JAX
command's, character for character, on the same file.

Usage:
    python -m repro_torch.launch.inspect trace repro_trace.json
    python -m repro_torch.launch.inspect validate repro_trace.json
    python -m repro_torch.launch.inspect metrics metrics.jsonl
    python -m repro_torch.launch.inspect solve --smoke --trace out.json \\
        --metrics out.jsonl [--device cpu --executor torch]
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Any, Dict, List

__all__ = ["sparkline", "summarize_trace", "main"]

#: eight-level block ramp; one cell per residual sample.
SPARK_CHARS = "▁▂▃▄▅▆▇█"


def sparkline(values, *, log: bool = True, width: int = 72) -> str:
    """Render ``values`` as a text sparkline, log-scaled by default.

    Residual norms span many decades, so the log of each value is mapped onto
    the eight block characters; non-finite or non-positive values render as
    spaces.  When there are more samples than ``width`` the series is
    decimated by striding (first and last samples always kept).
    """
    vals = [float(v) for v in values]
    if not vals:
        return ""
    if len(vals) > width:
        stride = (len(vals) - 1) / (width - 1)
        vals = [vals[round(i * stride)] for i in range(width)]
    keyed = []
    for v in vals:
        if not math.isfinite(v) or (log and v <= 0.0):
            keyed.append(None)
        else:
            keyed.append(math.log10(v) if log else v)
    finite = [k for k in keyed if k is not None]
    if not finite:
        return " " * len(vals)
    lo, hi = min(finite), max(finite)
    span = hi - lo
    out = []
    for k in keyed:
        if k is None:
            out.append(" ")
        elif span == 0.0:
            out.append(SPARK_CHARS[-1])
        else:
            out.append(SPARK_CHARS[int((k - lo) / span * (len(SPARK_CHARS) - 1))])
    return "".join(out)


def _fmt_table(rows: List[tuple], header: tuple) -> str:
    """Align ``rows`` of strings under ``header``."""
    all_rows = [header] + rows
    widths = [max(len(r[i]) for r in all_rows) for i in range(len(header))]
    lines = ["  ".join(h.ljust(w) for h, w in zip(header, widths))]
    lines.append("  ".join("-" * w for w in widths))
    for r in rows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
    return "\n".join(lines)


def summarize_trace(data) -> str:
    """Human summary of a Chrome trace object (or a path to one): per-name
    span totals, then the ``dispatch`` events' count and host time per op."""
    if isinstance(data, str):
        with open(data) as f:
            data = json.load(f)
    events = data.get("traceEvents", [])
    lines = [f"{len(events)} events"]

    # -- span table: total duration per (category, name) -----------------------
    spans: Dict[tuple, Dict[str, float]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        row = spans.setdefault((ev.get("cat", ""), ev["name"]),
                               {"count": 0, "dur_us": 0.0})
        row["count"] += 1
        row["dur_us"] += float(ev.get("dur", 0.0))
    if spans:
        rows = [
            (cat, name, str(row["count"]), f"{row['dur_us'] / 1e3:.3f}")
            for (cat, name), row in sorted(spans.items(),
                                           key=lambda kv: -kv[1]["dur_us"])
        ]
        lines.append("")
        lines.append(_fmt_table(rows, ("cat", "name", "count", "total_ms")))

    # -- dispatch events: count and host time per op x space x target ---------
    agg: Dict[tuple, Dict[str, Any]] = {}
    for ev in events:
        if ev.get("cat") != "dispatch" or ev.get("ph") != "X":
            continue
        args = ev.get("args", {})
        key = (ev["name"], args.get("space", "?"), args.get("target", "?"))
        row = agg.setdefault(key, {"count": 0, "host_us": 0.0})
        row["count"] += 1
        row["host_us"] += float(ev.get("dur", 0.0))
    if agg:
        rows = [(op, space, target, str(row["count"]),
                 f"{row['host_us'] / 1e3:.3f}")
                for (op, space, target), row in sorted(agg.items())]
        lines.append("")
        lines.append("dispatches (host time; device time is the profiler's):")
        lines.append(_fmt_table(
            rows, ("op", "space", "target", "count", "host_ms")))
    return "\n".join(lines)


def _metrics_table(records: List[Dict[str, Any]]) -> str:
    rows = []
    for rec in records:
        labels = ",".join(
            f"{k}={v}" for k, v in sorted(rec.get("labels", {}).items()))
        if rec.get("kind") == "histogram":
            val = (f"n={rec['count']} mean={rec['mean']:.3g} "
                   f"min={rec['min']:.3g} max={rec['max']:.3g}"
                   if rec.get("count") else "n=0")
        else:
            val = f"{rec.get('value', 0.0):.6g}"
        rows.append((rec.get("name", "?"), labels, rec.get("kind", "?"), val))
    if not rows:
        return "(no metrics recorded)"
    return _fmt_table(rows, ("metric", "labels", "kind", "value"))


# =============================================================================
# subcommands
# =============================================================================


def _cmd_trace(args) -> int:
    print(summarize_trace(args.file))
    return 0


def _cmd_validate(args) -> int:
    from repro_torch.observability import trace as trace_mod

    errors = trace_mod.validate_trace(args.file)
    if errors:
        for e in errors:
            print(f"INVALID: {e}")
        print(f"trace-schema: FAIL ({args.file}: {len(errors)} problems)")
        return 1
    print(f"trace-schema: OK ({args.file})")
    return 0


def _cmd_metrics(args) -> int:
    from repro_torch.observability import metrics as metrics_mod

    print(_metrics_table(metrics_mod.load_jsonl(args.file)))
    return 0


def _cmd_solve(args) -> int:
    # imports deferred: trace / validate / metrics read files only
    import time

    import numpy as np
    import torch

    from repro_torch.core import default_device, make_executor, synchronize
    from repro_torch.launch.dist_solve import build_system
    from repro_torch.observability import convergence, metrics, trace
    from repro_torch.solvers import krylov
    from repro_torch.solvers.common import Stop
    from repro_torch.sparse import csr_from_arrays

    if args.trace:
        trace.enable(args.trace)
    device = torch.device(args.device) if args.device else default_device()
    executor = args.executor or ("cuda" if device.type == "cuda" else "torch")

    n = 225 if args.smoke else args.n
    nonsym = args.solver in ("bicgstab", "cgs", "gmres")
    host, xstar, b = build_system(n, nonsym=nonsym)
    A = csr_from_arrays(*host, (n, n), device=device)
    stop = Stop(max_iters=args.max_iters, reduction_factor=args.tol)
    fn = getattr(krylov, args.solver)

    ex = make_executor(executor, device=device)
    with ex.activate():
        with trace.span("solve", solver=args.solver, n=n):
            t0 = time.perf_counter()
            res = fn(A, torch.as_tensor(b, device=device), stop=stop,
                     executor=ex, history=True)
            synchronize()
            wall = time.perf_counter() - t0

    hist = convergence.trim(res.history)
    err = float(np.abs(res.x.detach().cpu().numpy() - xstar).max())
    print(
        f"inspect solve: {args.solver} n={n} executor={executor} "
        f"device={device}  {int(res.iterations)} iters in {wall * 1e3:.1f} ms, "
        f"residual {float(res.residual_norm):.3e}, error {err:.3e}")
    if hist is not None and len(hist):
        lo, hi = float(np.nanmin(hist)), float(np.nanmax(hist))
        print(f"  residual history ({len(hist)} samples, log scale, "
              f"{hi:.2e} .. {lo:.2e}):")
        print(f"  {sparkline(hist)}")
    if args.metrics:
        metrics.export_jsonl(args.metrics)
        print(f"  metrics -> {args.metrics}")
    if args.trace and trace.export():
        print(f"  trace -> {args.trace}")
    ok = bool(res.converged) and hist is not None and len(hist) > 0
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.inspect", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("trace", help="summarize a Chrome trace file")
    p.add_argument("file")
    p.set_defaults(fn=_cmd_trace)

    p = sub.add_parser("validate", help="schema-check a trace file (CI gate)")
    p.add_argument("file")
    p.set_defaults(fn=_cmd_validate)

    p = sub.add_parser("metrics", help="render a metrics JSONL as a table")
    p.add_argument("file")
    p.set_defaults(fn=_cmd_metrics)

    p = sub.add_parser(
        "solve", help="demo solve with convergence telemetry + sparkline")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--solver", default="cg",
                   choices=("cg", "fcg", "bicgstab", "cgs", "gmres"))
    p.add_argument("--device", default=None,
                   help="cpu, or the card when not given")
    p.add_argument("--executor", default=None,
                   choices=("cuda", "torch", "reference"),
                   help="cuda on the card, torch on the CPU when not given")
    p.add_argument("--max-iters", type=int, default=500)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--trace", metavar="OUT_JSON", default=None)
    p.add_argument("--metrics", metavar="OUT_JSONL", default=None)
    p.set_defaults(fn=_cmd_solve)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
