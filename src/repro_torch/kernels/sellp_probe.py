"""What bounds ``spmv_sellp`` on a power-law matrix: the kernel's time and
bandwidth at each launch geometry.

    PYTHONPATH=src python -m repro_torch.kernels.sellp_probe

Builds ``power_law_laplacian(2**21, seed=4)`` as SELL-P (C = 8, stride 8,
f32) on the card and times ``spmv_sellp`` (CUDA events, median of 30 runs,
L2 flushed before each) at every ``block_threads`` (the range size follows
from it: :func:`~repro_torch.kernels.spmv_sellp.kernel.range_cols`), each
held against its plain version per row (2 (w + 1) eps of the row's
magnitude, w its slice's width) and repeated bit for bit.  Each time is
printed with the bandwidth it gives over the stored bytes (every slot,
padding included, its column index and value; slice_sets; x and y once) and
over the true bytes (the CSR nonzeros' index and value, x and y once: what
``portbench/counting.py`` counts), and with the warps of a wave, the range
size and count and the slices a range boundary cuts (:func:`sellp_geometry`).
The seed geometry is also timed with C = 32, with C = 12 (V = 4 lanes'
loads, ten columns a step), with C = 18 and 96 (lanes idle past a column's
last lane-load) and in f64.  Prints one JSON object last; exits non-zero without a CUDA device
or when a geometry disagrees with the plain version or does not repeat.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch



def device_ms(fn, flush, reps: int = 30) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2 ** 21)
    ap.add_argument("--seed", type=int, default=4)
    ap.add_argument("--block-threads", type=int, nargs="+",
                    default=[64, 128, 256, 512])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    from repro_torch import kernels as K
    from repro_torch.kernels.spmv_sellp.kernel import (BLOCK_THREADS,
                                                       range_cols,
                                                       resident_warps,
                                                       sellp_geometry)
    from repro_torch.sparse import gallery, sellp_from_csr_host

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    ip, ix, v, shape = gallery.power_law_laplacian(args.n, seed=args.seed)
    m = shape[0]
    nnz = int(ix.size)
    A = sellp_from_csr_host(ip, ix, v, shape, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x32 = torch.randn(m, generator=gen, device="cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    out = {"card": card, "m": m, "nnz": nnz, "stored": A.nnz,
           "widest_slice": A.max_slice_cols, "geometries": []}

    def held(B, x, bt):
        """Time of spmv_sellp on B at ``bt`` threads a block, after its
        per-row check and a bitwise repeat."""
        a = (B.col_idx, B.values, B.slice_sets, x, m, B.slice_size)
        geo = dict(block_threads=bt)
        y = K.spmv_sellp(*a, **geo)
        same = torch.equal(y, K.spmv_sellp(*a, **geo))
        y_ref = K.spmv_sellp_plain(*a)
        mag = K.spmv_sellp_plain(B.col_idx, B.values.abs(), B.slice_sets,
                                 x.abs(), m, B.slice_size)
        width = B.slice_cols.repeat_interleave(B.slice_size)[:m].to(mag.dtype)
        eps = torch.finfo(x.dtype).eps
        tol = (2 * (width + 1) * eps * mag).clamp_min(1e-30)
        ratio = float(((y - y_ref).abs() / tol).max())
        if not ratio <= 1.0 or not same:
            print(f"FAIL: spmv_sellp at C = {B.slice_size}, {x.dtype}, {geo}: "
                  f"{ratio} of the per-row tolerance, repeat bitwise equal "
                  f"{same}", file=sys.stderr)
            sys.exit(1)
        ms = device_ms(lambda: K.spmv_sellp(*a, **geo), flush)
        s = x.element_size()
        stored = B.nnz * (4 + s) + B.slice_sets.numel() * 4 + 2 * m * s
        true = nnz * (4 + s) + 2 * m * s
        warps = resident_warps(B.col_idx, B.values, B.slice_size, bt)
        R = range_cols(B.slice_size, B.values.numel() // B.slice_size, warps)
        row = {"C": B.slice_size, "dtype": str(x.dtype).replace("torch.", ""),
               **geo, "ms": ms, "stored_gbs": stored / ms / 1e6,
               "true_gbs": true / ms / 1e6, "tolerance_share": ratio,
               "resident_warps": warps,
               **sellp_geometry(B.slice_size, B.slice_sets, R,
                                itemsize=x.element_size())}
        print(f"[sellp_probe] C {B.slice_size:3d} {row['dtype']} "
              f"block_threads {bt:5d}: {ms:.4f} ms, "
              f"{row['stored_gbs']:.1f} GB/s stored, {row['true_gbs']:.1f} "
              f"GB/s true ({warps} warps a wave, {row['ranges']} ranges of "
              f"{R} columns, {row['carries']} slices cut)", flush=True)
        return row

    for bt in args.block_threads:
        out["geometries"].append(held(A, x32, bt))
    out["f64"] = held(sellp_from_csr_host(ip, ix, v.astype("float64"), shape,
                                          device="cuda"),
                      x32.double(), BLOCK_THREADS)
    for C in (32, 12, 18, 96):
        B = sellp_from_csr_host(ip, ix, v, shape, slice_size=C, device="cuda")
        out[f"c{C}"] = held(B, x32, BLOCK_THREADS)
        del B
    best = min(out["geometries"], key=lambda g: g["ms"])
    print(f"[sellp_probe] fastest: block_threads {best['block_threads']}: "
          f"{best['ms']:.4f} ms", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
