"""The rule that fixes a Graph 500 configuration's ``graph_seed``.

    python3 portbench/graph_seed.py --config <config> [--seeds 1-21] [--out FILE]

For each seed, on the card: the graph of the configuration's parameters
with that seed, its nonzeros, largest degree and isolated share, the slots
the configuration's SELL-P layout stores (worked out from the row lengths),
and the iterations the plain reference's Jacobi CG takes on one fixed
right-hand side.  The chosen seed is the one whose solve work (iterations
times stored slots) is the median over the seeds, the smaller seed on a
tie.  One JSON line a seed, then the summary.  The benchmark's own runs
never run it.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def sellp_slots(row_nnz, slice_size: int, stride_factor: int) -> int:
    """Stored slots of a SELL-P layout: each slice of ``slice_size`` rows
    padded to its longest row, rounded up to ``stride_factor`` columns (at
    least one)."""
    import numpy as np

    C, sf = int(slice_size), int(stride_factor)
    ns = -(-row_nnz.size // C)
    rn = np.zeros(ns * C, np.int64)
    rn[:row_nnz.size] = row_nnz
    w = np.maximum(rn.reshape(ns, C).max(axis=1), 1)
    return int((((w + sf - 1) // sf) * sf).sum()) * C


def readings(config: str, seeds, *, device: str = "cuda", emit=print) -> dict:
    import numpy as np
    import torch

    from portbench import spec

    bench = spec.load(ROOT)
    cfg = spec.read_json(ROOT / spec.config_entry(bench, config)["file"])
    gen = spec.load_module(
        ROOT / "portbench" / "generators" / f"{cfg['problem']['generator']}.py", "gen")
    ref = {part: spec.load_module(ROOT / "portbench" / "reference" / f"{name}.py",
                                  "ref")
           for part, name in cfg["reference"].items()}
    kw = cfg["program"]["format"].get("kwargs", {})
    stop = cfg["program"]["stop"]
    rows = []
    for s in seeds:
        params = dict(cfg["problem"]["params"], graph_seed=int(s))
        host = gen.generate(params, device=device)
        indptr = host[0]
        row_nnz = np.diff(indptr)
        n = int(host[3][0])
        A = ref["operator"].build(host, dtype=torch.float64, device=device)
        M = ref["preconditioner"].build(host, {}, working=torch.float64,
                                        compute_dtype=torch.float64, device=device)
        g = torch.Generator(device=device).manual_seed(0)
        b = torch.randn(n, generator=g, dtype=torch.float64, device=device)
        r = ref["solver"].solve(A.apply, M.apply, b, stop, dtype=torch.float64)
        slots = sellp_slots(row_nnz, kw.get("slice_size", 8), kw.get("stride_factor", 8))
        rows.append({"graph_seed": int(s), "nonzeros": int(indptr[-1]),
                     "max_degree": int(row_nnz.max()) - 1,
                     "isolated_share": float(np.mean(row_nnz == 1)),
                     "sellp_slots": slots, "iterations": r.iterations,
                     "work": r.iterations * slots})
        emit(json.dumps(rows[-1]))
        del host, A, M, b, r
        if device == "cuda":
            torch.cuda.empty_cache()
    order = sorted(rows, key=lambda q: (q["work"], q["graph_seed"]))
    chosen = order[(len(order) - 1) // 2]
    summary = {"config": config, "seeds": len(rows), "chosen": chosen["graph_seed"],
               "rule": "median of iterations x stored SELL-P slots, smaller seed on a tie",
               **{f"{k}_range": [min(q[k] for q in rows), max(q[k] for q in rows)]
                  for k in ("nonzeros", "max_degree", "sellp_slots", "iterations")}}
    emit(json.dumps({"summary": summary}))
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", default="1-21")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    lo, _, hi = args.seeds.partition("-")
    seeds = range(int(lo), int(hi or lo) + 1)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p and str(Path(p).resolve()) != here]
    sys.path[:0] = [str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    lines = []

    def emit(line):
        print(line, flush=True)
        lines.append(line)
    readings(args.config, seeds, emit=emit)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
