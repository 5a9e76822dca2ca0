"""What bounds ``spmv_sellp`` on a power-law matrix: the kernel's time at
each launch geometry, against its walk of every slice by one warp.

    PYTHONPATH=src python -m repro_torch.kernels.sellp_probe

Builds ``power_law_laplacian(2**21, seed=4)`` as SELL-P (C = 8, stride 8,
f32) on the card and times ``spmv_sellp`` (CUDA events, median of 30 runs,
L2 flushed before each) at every ``block_threads`` x ``wide_cols`` pair, each
held against its plain version per row (2 (w + 1) eps of the row's
magnitude, w its slice's width).  ``wide_cols = none`` walks every slice with
one warp (C dividing 32), hub slices included.  It also counts the
lane-steps the warps issue against the stored entries (a warp walks one
slice, 32 consecutive entries a step, so only a slice's last step runs
part-empty; the one-thread-per-row walk it replaced ran a warp over four
slices of C = 8 as long as the widest, whose count is printed beside), and
times the warp walk and the seed geometry with C = 32 (one lane a row), with
C = 12 (C not dividing 32: a thread per row) and with every row cut to its
first 64 entries (no hub row).  Prints one JSON object last; exits non-zero
without a CUDA device or when a geometry disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

#: ``wide_cols`` past every slice's width: no slice is left to the block
NO_WIDE = 2 ** 31 - 1
#: the H100 seed geometry (``kernels/spmv_sellp/ops.py``): block_threads,
#: wide_cols
SEED = (512, 256)


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
                    default=[128, 256, 512, 1024])
    ap.add_argument("--wide-cols", type=int, nargs="+",
                    default=[32, 64, 128, 256, 512])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    from repro_torch import kernels as K
    from repro_torch.sparse import gallery, sellp_from_csr_host

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    ip, ix, v, shape = gallery.power_law_laplacian(args.n, seed=args.seed)
    m = shape[0]
    A = sellp_from_csr_host(ip, ix, v, shape, device="cuda")
    C = A.slice_size
    x = torch.randn(m, generator=torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    eps = torch.finfo(torch.float32).eps
    out = {"card": card, "m": m, "nnz": int(ix.size), "stored": A.nnz,
           "widest_slice": A.max_slice_cols, "geometries": []}

    def held(B, bt, wide):
        """Time of spmv_sellp on B at (bt, wide), after its per-row check."""
        a = (B.col_idx, B.values, B.slice_sets, x, m, B.slice_size)
        geo = dict(block_threads=bt, wide_cols=wide)
        y = K.spmv_sellp(*a, **geo)
        y_ref = K.spmv_sellp_plain(*a)
        mag = K.spmv_sellp_plain(B.col_idx, B.values.abs(), B.slice_sets,
                                 x.abs(), m, B.slice_size)
        width = B.slice_cols.repeat_interleave(B.slice_size)[:m].to(mag.dtype)
        tol = (2 * (width + 1) * eps * mag).clamp_min(1e-30)
        ratio = float(((y - y_ref).abs() / tol).max())
        if not ratio <= 1.0:
            print(f"FAIL: spmv_sellp at {geo}: {ratio} of the per-row "
                  "tolerance", file=sys.stderr)
            sys.exit(1)
        return device_ms(lambda: K.spmv_sellp(*a, **geo), flush)

    for bt in args.block_threads:
        for wide in args.wide_cols + [NO_WIDE]:
            ms = held(A, bt, wide)
            name = "none" if wide == NO_WIDE else wide
            out["geometries"].append({"block_threads": bt, "wide_cols": name,
                                      "ms": ms})
            print(f"[sellp_probe] block_threads {bt:5d} wide_cols {name!s:>5}: "
                  f"{ms:.4f} ms", flush=True)

    widths = A.slice_cols.cpu().numpy().astype(np.int64)
    out["stored_lane_steps"] = int(widths.sum() * C)
    per_warp = max(32 // C, 1)
    pad = (-widths.size) % per_warp
    warp_width = np.concatenate([widths, np.zeros(pad, np.int64)]).reshape(
        -1, per_warp).max(axis=1)
    out["row_walk_lane_steps"] = int(warp_width.sum() * 32)
    out["warp_walk_lane_steps"] = int((-(-widths * C // 32)).sum() * 32)
    del A
    B32 = sellp_from_csr_host(ip, ix, v, shape, slice_size=32, device="cuda")
    out["c32_stored"] = B32.nnz
    out["c32_no_wide_ms"] = held(B32, 512, NO_WIDE)
    out["c32_seed_ms"] = held(B32, *SEED)
    del B32
    B12 = sellp_from_csr_host(ip, ix, v, shape, slice_size=12, device="cuda")
    out["c12_stored"] = B12.nnz
    out["c12_seed_ms"] = held(B12, *SEED)
    del B12
    keep = np.arange(ix.size) - np.repeat(ip[:-1], np.diff(ip)) < 64
    ip_cut = np.concatenate([[0], np.cumsum(np.minimum(np.diff(ip), 64))])
    Bcut = sellp_from_csr_host(ip_cut, ix[keep], v[keep], shape, device="cuda")
    out["cut64_nnz"] = int(keep.sum())
    out["cut64_stored"] = Bcut.nnz
    out["cut64_no_wide_ms"] = held(Bcut, 512, NO_WIDE)
    out["cut64_seed_ms"] = held(Bcut, *SEED)
    print(f"[sellp_probe] warps issue {out['warp_walk_lane_steps']} lane-steps "
          f"for {out['stored_lane_steps']} stored entries (a thread per row: "
          f"{out['row_walk_lane_steps']}); C = 32 "
          f"({out['c32_stored']} stored): warp walk "
          f"{out['c32_no_wide_ms']:.4f} ms, seed {out['c32_seed_ms']:.4f} ms; "
          f"C = 12 ({out['c12_stored']} stored, a thread per row): seed "
          f"{out['c12_seed_ms']:.4f} ms; "
          f"rows cut to 64 entries ({out['cut64_stored']} stored): warp walk "
          f"{out['cut64_no_wide_ms']:.4f} ms, seed {out['cut64_seed_ms']:.4f} ms",
          flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
