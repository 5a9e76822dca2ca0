"""Digests of ``spmv_batch_ell``'s results, to hold two trees' kernels bit for
bit on one card (CUDA only).

    PYTHONPATH=<tree>/src python src/repro_torch/kernels/batch_ell_digest.py

runs the kernel of the ``repro_torch`` that ``PYTHONPATH`` names on seeded
inputs, at each route the registry binding picks for the shapes below (the
batched solves' two path shapes, the cases chip_smoke.py's phase 7 holds and
the widest rows the tile kernel takes: k = 512 in f32, 256 in f64), and
prints one JSON object, case -> SHA-256 of the result's bytes.  Run it for
two trees in one call and compare the objects: equal digests are equal bits.
"""

from __future__ import annotations

import argparse
import hashlib
import json

import torch

#: (nb, m, k, n, dtype name, values offset in entries)
CASES = (
    (16384, 1024, 3, 1024, "float32", 0),
    (1024, 64, 64, 64, "float32", 0),
    (7, 61, 61, 61, "float32", 0),
    (3, 64, 64, 64, "float32", 1),
    (5, 50, 24, 50, "float32", 0),
    (3, 37, 5, 29, "float32", 0),
    (16384, 1024, 3, 1024, "float64", 0),
    (1024, 64, 64, 64, "float64", 0),
    (5000, 64, 64, 64, "float32", 0),
    (8, 96, 512, 600, "float32", 0),
    (8, 96, 509, 600, "float32", 0),
    (8, 96, 256, 300, "float64", 0),
)


def digests(seed: int = 0) -> dict:
    from repro_torch import kernels as K
    from repro_torch.core import make_executor

    ex = make_executor("cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for nb, m, k, n, dtype_name, offset in CASES:
        dtype = getattr(torch, dtype_name)
        cols = torch.randint(0, n, (m, k), generator=gen, device="cuda",
                             dtype=torch.int32)
        fill = torch.randint(0, k + 1, (m,), generator=gen, device="cuda")
        pad = torch.arange(k, device="cuda")[None, :] >= fill[:, None]
        cols[pad] = 0
        flat = torch.randn(nb * m * k + offset, generator=gen, device="cuda",
                           dtype=dtype)
        vals = flat[offset:].view(nb, m, k)
        vals[:, pad] = 0
        X = torch.randn(nb, n, generator=gen, device="cuda", dtype=dtype)
        cfg = ex.launch_config("spmv_batch_ell", {
            "m": m, "k": k, "n": n, "itemsize": vals.element_size()})
        y = K.spmv_batch_ell(cols, vals, X, block_threads=cfg["block_threads"],
                             subgroup=cfg["subgroup"])
        key = f"{nb}x{m}x{k} n={n} {dtype_name} offset={offset} " \
              f"subgroup={cfg['subgroup']}"
        out[key] = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(json.dumps(digests(args.seed)))


if __name__ == "__main__":
    main()
