"""Persistent solve-service entry point: continuous batching + setup cache.

Stands up :class:`repro_torch.serve.SolveService`, replays a synthetic
Poisson request stream over a sparsity-pattern gallery
(:mod:`repro_torch.serve.traffic`), and reports solves/s, p50/p99
end-to-end latency (from the ``serve_latency_s`` histogram) and the setup
cache's hit rates per tier.

A warm-up pass (one request per gallery pattern) fills the pattern tier, as
a long-running service would be; the measured stream then runs against a
warm cache.  The run ends with ``SERVE-GATE: PASS|FAIL``: every request
converged, the cache hit, and p99 latency stayed under the bound.

Runs on the card through the CUDA kernels unless asked otherwise:

    python -m repro_torch.launch.solve_serve
    python -m repro_torch.launch.solve_serve --smoke --device cpu --executor torch
    python -m repro_torch.launch.solve_serve --requests 256 --rate-hz 200 \\
        --gallery 4 --repeat-ratio 0.6 --slots 8 --p99-bound 0.5
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import default_device, make_executor
from repro_torch.observability import metrics, trace
from repro_torch.serve import ServeConfig, SolveService, TrafficConfig
from repro_torch.serve.cache import cache_stats
from repro_torch.serve.request import SolveRequest
from repro_torch.serve.traffic import generate_traffic, pattern_gallery
from repro_torch.solvers.common import Stop

__all__ = ["run_serve", "report", "main"]


def _warmup(svc: SolveService, traffic_cfg: TrafficConfig) -> None:
    """One solve per gallery pattern: fills the pattern tier and builds the
    lanes' closures."""
    rng = np.random.default_rng(traffic_cfg.seed + 97)
    ids = []
    for indptr, indices, make_values in pattern_gallery(traffic_cfg):
        req = SolveRequest(
            indptr=indptr, indices=indices, values=make_values()[2],
            b=rng.normal(size=traffic_cfg.n).astype(np.float32),
            shape=(traffic_cfg.n, traffic_cfg.n),
        )
        ids.append(svc.submit(req))
    svc.gather(ids, timeout=300.0)


def run_serve(config: ServeConfig, traffic_cfg: TrafficConfig, *,
              executor=None, pace: bool = True, traffic=None):
    """Warm up, replay the stream (``traffic``, else generated from
    ``traffic_cfg``) and return ``(responses, wall_s)``; the metrics
    registry is reset after the warm-up."""
    if traffic is None:
        traffic = generate_traffic(traffic_cfg)
    with SolveService(config, executor=executor) as svc:
        _warmup(svc, traffic_cfg)
        metrics.reset()  # measure the steady state, not the warm-up
        t0 = time.perf_counter()
        ids = []
        for gap, req in traffic:
            if pace and gap > 0:
                time.sleep(gap)
            ids.append(svc.submit(req))
        responses = svc.gather(ids, timeout=600.0)
        wall = time.perf_counter() - t0
    return responses, wall


def _fmt_s(v) -> str:
    return "n/a" if v is None else f"{v * 1e3:.3g} ms"


def report(responses, wall: float, p99_bound: float) -> bool:
    """Print the run's numbers and the ``SERVE-GATE`` line; True on PASS."""
    num = len(responses)
    converged = sum(r.converged for r in responses)
    p_hits = sum(r.pattern_hit for r in responses)
    f_hits = sum(r.factors_hit for r in responses)
    iters = sum(r.iterations for r in responses)
    h = metrics.histogram("serve_latency_s")
    p50, p99 = h.quantile(0.5), h.quantile(0.99)
    rate = num / max(wall, 1e-9)
    print(f"solve_serve: {num} requests in {wall:.3f} s "
          f"({rate:.1f} solves/sec, {iters} total iterations)")
    print(f"  converged {converged}/{num}")
    print(f"  cache hits: pattern {p_hits}/{num}  factors {f_hits}/{num}")
    print(f"  cache counters: { {k: int(v) for k, v in sorted(cache_stats().items())} }")
    print(f"  latency p50 = {_fmt_s(p50)}  p99 = {_fmt_s(p99)}  "
          f"(bound {p99_bound:g} s)")
    ok = converged == num and p_hits > 0 and p99 is not None and p99 < p99_bound
    print(f"SERVE-GATE: {'PASS' if ok else 'FAIL'}", flush=True)
    return ok


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small end-to-end run (48 requests, gallery of 3)")
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--rate-hz", type=float, default=200.0,
                    help="Poisson arrival rate of the synthetic stream")
    ap.add_argument("--gallery", type=int, default=4,
                    help="distinct sparsity patterns in the traffic")
    ap.add_argument("--repeat-ratio", type=float, default=0.6,
                    help="fraction of requests reusing a previous matrix")
    ap.add_argument("--n", type=int, default=24, help="rows per system")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=8,
                    help="batch slots per pattern lane")
    ap.add_argument("--chunk-sweeps", type=int, default=8,
                    help="masked sweeps per advance chunk")
    ap.add_argument("--solver", default="cg", choices=("cg", "bicgstab"))
    ap.add_argument("--format", default="csr", choices=("csr", "ell"),
                    dest="fmt")
    ap.add_argument("--precond", default="block_jacobi",
                    choices=("block_jacobi", "none"))
    ap.add_argument("--block-size", type=int, default=4)
    ap.add_argument("--max-iters", type=int, default=500)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--p99-bound", type=float, default=2.0,
                    help="gate: p99 end-to-end latency must stay under this")
    ap.add_argument("--no-pace", action="store_true",
                    help="submit the whole stream at once (throughput mode)")
    ap.add_argument("--executor", default="cuda",
                    help="executor kind (cuda | torch | reference) or hardware "
                         "target name (default: the CUDA kernels on the card)")
    ap.add_argument("--device", default=None,
                    help="device of the run (default: the card; 'cpu' asks for "
                         "the CPU with --executor torch|reference)")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="write the metrics registry snapshot here")
    trace.add_cli_flag(ap)
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    device = torch.device(args.device) if args.device else default_device()
    ex = make_executor(args.executor, device=device)
    if ex.kernel_space == "cuda" and device.type != "cuda":
        ap.error("the cuda executor runs on the card; use --executor "
                 "torch|reference with --device cpu")
    trace.enable_from_args(args)

    requests = 48 if args.smoke else args.requests
    gallery = min(args.gallery, 3) if args.smoke else args.gallery
    config = ServeConfig(
        slots=args.slots, chunk_sweeps=args.chunk_sweeps, solver=args.solver,
        fmt=args.fmt, precond=args.precond, block_size=args.block_size,
        stop=Stop(max_iters=args.max_iters, reduction_factor=args.tol),
    )
    traffic_cfg = TrafficConfig(
        num_requests=requests, rate_hz=args.rate_hz, gallery_size=gallery,
        repeat_ratio=args.repeat_ratio, n=args.n, seed=args.seed,
    )
    print(f"solve_serve: {requests} requests @ {args.rate_hz:g} Hz, "
          f"gallery={gallery} repeat={args.repeat_ratio:g}, "
          f"{args.solver}/{args.fmt}/{args.precond} slots={args.slots}, "
          f"seed={args.seed}, executor {ex.name} on {ex.device}", flush=True)
    responses, wall = run_serve(config, traffic_cfg, executor=ex,
                                pace=not args.no_pace)
    ok = report(responses, wall, args.p99_bound)
    if args.metrics_jsonl:
        print(f"  metrics -> {metrics.export_jsonl(args.metrics_jsonl)}")
    if args.trace:
        trace.export(args.trace)
        trace.reset()
        print(f"  trace -> {args.trace}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
