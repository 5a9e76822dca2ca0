"""The RWKV6 model's accuracy at long context (card only).

    PYTHONPATH=src python -m repro_torch.kernels.long_probe [--out PATH]

RWKV6-3B at full width and depth on one sequence of S = 2,048, 8,192 and
32,768 random tokens at the JAX package's init (every decay e^-1):
last-position prefill logits of the cuda and torch spaces in bf16 and of
the cuda space (and, to 8,192, the torch space) in f32, each against the
cuda space's f32 result, as a share of max |logit|.  (``chip_smoke.py``
phase 16 holds ``rwkv6_scan_log`` and ``flash_attention`` themselves at
32k.)

TF32 is off.  Prints the card's name and power limit first and one JSON
object last (also written to ``--out``); exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys

import torch


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def rwkv6_model() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import make_executor
    from repro_torch.launch import steps
    from repro_torch.models import lm

    dev = torch.device("cuda")
    ex, ex_t = make_executor("cuda"), make_executor("torch", device=dev)
    base = get_config("rwkv6-3b")
    out = {}
    for S in (2048, 8192, 32768):
        logits = {}
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(base, dtype=dtype)
            params = lm.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
            toks = torch.randint(0, cfg.vocab, (1, S), device=dev, dtype=torch.int32,
                                 generator=torch.Generator(dev).manual_seed(5))
            for space, e in (("cuda", ex), ("torch", ex_t)):
                if dtype == "float32" and space == "torch" and S > 8192:
                    continue
                with torch.no_grad():
                    logits[f"{dtype} {space}"] = steps.make_prefill_step(
                        cfg, executor=e)(params, {"tokens": toks},
                                         lm.init_cache(cfg, 1, S, dev))[0].float()
            del params
            torch.cuda.empty_cache()
        ref = logits["float32 cuda"]
        out[S] = {f"{k} vs float32 cuda": _rel(v, ref) for k, v in logits.items()
                  if k != "float32 cuda"}
        out[S]["bfloat16 cuda vs bfloat16 torch"] = _rel(
            logits["bfloat16 cuda"], logits["bfloat16 torch"])
        print(f"rwkv6-3b S {S}: {out[S]}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"card": card, "rwkv6_model": rwkv6_model()}
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
