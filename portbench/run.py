"""Run one cell of the port's benchmark on the card this process finds.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, on standard output, a line with the set-up split and a line with
the sampled solves' numbers, then the result as the last line (one JSON
object); on standard error, last, each number ``correct`` compared beside
its limit.  Exits non-zero, printing no result, without a CUDA card (or
fewer cards than the cell asks for), or when ``jax``, ``jaxlib``, ``flax``
or the JAX package ``repro`` is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p and str(Path(p).resolve()) != here]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    import repro_torch  # noqa: F401  the system under test: none, no run
    from portbench import harness, spec

    cell = spec.workload(spec.load(ROOT), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"the cell asks for {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))

    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           root=ROOT, device="cuda", t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded in this process: {found}", file=sys.stderr)
        return 3
    safe = harness.json_safe
    print(json.dumps(safe({"setup_split_s": out["setup_split_s"],
                           "setup_s": out["setup_s"], "problem": out["problem"]})))
    print(json.dumps(safe({"samples": out["samples"],
                           "uncompared": out["uncompared"]})))
    res = safe(out["result"])
    print(json.dumps(res, allow_nan=False), flush=True)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
