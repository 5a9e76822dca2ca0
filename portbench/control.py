"""The readings the limits of ``correct`` are set from, for one cell.

    python3 portbench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 2] [--out FILE]

In one process, set up as a run does: for each of ``--seeds``, a window of
``--seconds`` at the cell's own load on that seed's right-hand sides, its
seeded sample judged as a run judges it (the program's readings: their
largest is the lower reading).  Then, with the program freed, the control:
the reference put in the program's place and computed in the precision
below the cell's (bfloat16 for float32, float32 for float64), on the first
``check_solves`` right-hand sides of each of ``--control-seeds``, judged
alike (their smallest is the upper reading).  One JSON line a run, then a
summary line.  The benchmark's own runs never run the control.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: the precision below each working precision, the control's
LOWER = {"float64": "float32", "float32": "bfloat16"}


def readings(cell: str, seeds, control_seeds, seconds: float, *,
             device: str = "cuda", executor=None, overrides=None, emit=print,
             root: Path = ROOT) -> dict:
    import torch

    from portbench import harness, judge

    c = harness.load_cell(cell, root, overrides)
    on_card = device == "cuda"
    sp = harness.Spans(on_card)
    p = harness.setup(c, seeds[0], device=device, executor=executor, sp=sp)
    host, dev, dtype_name = p["host"], p["dev"], p["dtype"]
    k_check = int(c["traffic"]["check_solves"])
    runs = []
    for s in seeds:
        t0 = time.perf_counter()
        p["pool"] = harness.make_pool(c["traffic"], s, p["n"], dev)
        w = harness.run_window(p, seconds, k_check, s, sp)
        v = harness.check(c, host, w["samples"], w["converged"], dtype_name, dev)
        runs.append({"kind": "program", "seed": s, "correct": v["correct"],
                     "numbers": v["numbers"], "per": v["per"],
                     "solves": w["solves"], "seconds": time.perf_counter() - t0})
        emit(json.dumps(harness.json_safe(runs[-1])))
    del p
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    lower = LOWER[dtype_name]
    ctl = judge.Reference(c["reference"], host, c["config"], lower, dev, compute=lower)
    ref = judge.Reference(c["reference"], host, c["config"], dtype_name, dev)
    n = int(host[3][0])
    for s in control_seeds:
        t0 = time.perf_counter()
        pool = harness.make_pool(c["traffic"], s, n, dev)[:k_check].clone()
        per = []
        for idx in range(k_check):
            r = ctl.solve(pool[idx])
            per.append({"solve": idx, "converged": r.converged,
                        **judge.sample_numbers(ref, pool[idx], r.x, r.iterations,
                                               r.residual_norm)})
        numbers = judge.worst(per, sum(1 for q in per if not q["converged"]))
        ok, _ = judge.verdict(numbers, c["limits"])
        runs.append({"kind": "control", "precision": lower, "seed": s,
                     "correct": ok, "numbers": numbers, "per": per,
                     "seconds": time.perf_counter() - t0})
        emit(json.dumps(harness.json_safe(runs[-1])))
    keys = list(runs[0]["numbers"])
    prog = [r["numbers"] for r in runs if r["kind"] == "program"]
    ctrl = [r["numbers"] for r in runs if r["kind"] == "control"]
    summary = {"cell": cell, "setup_split_s": sp.s,
               "lower": {k: max(x[k] for x in prog) for k in keys},
               "upper": {k: min(x[k] for x in ctrl) for k in keys} if ctrl else {},
               "program_correct": [r["correct"] for r in runs if r["kind"] == "program"],
               "control_correct": [r["correct"] for r in runs if r["kind"] == "control"]}
    emit(json.dumps(harness.json_safe({"summary": summary})))
    return {"runs": runs, "summary": summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p and str(Path(p).resolve()) != here]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    lines = []

    def emit(line):
        print(line, flush=True)
        lines.append(line)
    readings(args.workload, [int(s) for s in args.seeds.split(",")],
             [int(s) for s in args.control_seeds.split(",") if s], args.seconds,
             emit=emit)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
