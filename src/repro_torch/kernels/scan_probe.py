"""Times ``ssd_scan`` and ``rwkv6_scan_log`` at the serving paths' shapes.

    PYTHONPATH=src python -m repro_torch.kernels.scan_probe [--out PATH]
        [--lib PATH] [--kernels NAME ...]

``ssd_scan``: Zamba2-2.7B's Mamba2 scan, B 8, S 2,048, H 80, P = N = 64,
G 2, bf16 x, B and C, f32 dt and A (``chip_smoke.py``'s phase 8 inputs); it
is also timed on the views ``mamba_forward`` hands over (rows of 5,376
elements: x, B and C cut from one conv output) where the wrapper takes
them: an older tree's wrapper refuses strided x, B and C, and the probe
then times the contiguous inputs alone, so one file times both sides of
an A/B.  ``rwkv6_scan_log``: RWKV6-3B's WKV scan, B 8, S 2,048,
H 40, K = V = 64, bf16 r, k, v and u, f32 logw = -exp(N(-1, 1)) (phase 9's
inputs).

Each kernel is held against its plain version with ``chip_smoke.py``'s
tolerances (y within 2^-7 |plain| + 1e-4 max |plain|, the state within 1e-4
of its max) and repeated bit for bit; each time is the median of 30
CUDA-event runs with the L2 flushed before each (``sellp_probe.device_ms``).
To time another tree's kernels, run this file by its path with
``PYTHONPATH`` naming that tree's ``src``; ``--lib`` loads a library built
elsewhere from the same entry points in place of the tree's own build, by
replacing the handle ``_build`` keeps (a variant of a source, for an A/B;
it is timed and repeated, not held to the plain version).  Prints the card's name and power limit
first and one JSON object last (also written to ``--out``); exits non-zero
without a CUDA device or when a kernel disagrees (~30 s on the card).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _held(name, got, want, tol_rel, tol_abs) -> float:
    """Largest error over its tolerance (chip_smoke.py's ``_held``)."""
    diff = (got.float() - want.float()).abs()
    bound = tol_rel * want.float().abs() + tol_abs * float(want.float().abs().max())
    worst = float((diff / bound).max())
    if not worst <= 1.0 or not bool(torch.isfinite(got.float()).all()):
        _fail(f"{name} disagrees with its plain version ({worst} of its tolerance)")
    return worst


def _probe(timer, name, kernel, plain, args, views=None, check=True) -> dict:
    yp, sp = plain(*args)
    out = {}
    for label, a in (("contiguous", args), ("views", views)):
        if a is None:
            continue
        y, s = kernel(*a)
        worst = (max(_held(f"{name} y", y, yp, 2.0 ** -7, 1e-4),
                     _held(f"{name} state", s, sp, 0.0, 1e-4))
                 if check else None)
        y2, s2 = kernel(*a)
        if not (torch.equal(y, y2) and torch.equal(s, s2)):
            _fail(f"{name} ({label}): a repeat is not bitwise equal")
        out[label] = {"ms": timer(lambda: kernel(*a)), "worst_of_tolerance": worst}
        print(f"{name} {label}: {out[label]['ms']:.4f} ms (largest error "
              f"{worst} of its tolerance)", flush=True)
        del y, s, y2, s2
    return out


def probe_ssd(timer, check=True) -> dict:
    from repro_torch import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(8)
    bf16 = torch.bfloat16
    B, S, H, P, G, N = 8, 2048, 80, 64, 2, 64
    # x, B and C as mamba_forward cuts them from one conv output (B, S,
    # H P + 2 G N); dt and A as chip_smoke.py draws them
    conv = torch.randn(B, S, H * P + 2 * G * N, generator=gen, device="cuda")
    conv[..., H * P:] *= 0.3
    conv = conv.to(bf16)
    xv, Bv, Cv = torch.split(conv, [H * P, G * N, G * N], dim=-1)
    xv, Bv, Cv = xv.reshape(B, S, H, P), Bv.reshape(B, S, G, N), Cv.reshape(B, S, G, N)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=gen, device="cuda") - 1)
    A = -torch.exp(0.5 * torch.randn(H, generator=gen, device="cuda"))
    args = (xv.contiguous(), dt, A, Bv.contiguous(), Cv.contiguous())
    takes_views = True
    try:  # a wrapper that refuses strided x, B and C times contiguous only
        K.ssd_scan(xv[:1, :64], dt[:1, :64], A, Bv[:1, :64], Cv[:1, :64])
    except ValueError:
        takes_views = False
    views = (xv, dt, A, Bv, Cv) if takes_views else None
    return {"shape": {"B": B, "S": S, "H": H, "P": P, "G": G, "N": N},
            **_probe(timer, "ssd_scan", K.ssd_scan, K.ssd_scan_plain, args, views,
                     check)}


def probe_rwkv6(timer, check=True) -> dict:
    from repro_torch import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(10)
    bf16 = torch.bfloat16
    B, S, H, D = 8, 2048, 40, 64
    r, k, v = (torch.randn(B, S, H, D, generator=gen, device="cuda").to(bf16)
               for _ in range(3))
    logw = -torch.exp(-1.0 + torch.randn(B, S, H, D, generator=gen, device="cuda"))
    u = (0.5 * torch.randn(H, D, generator=gen, device="cuda")).to(bf16)
    return {"shape": {"B": B, "S": S, "H": H, "K": D, "V": D},
            **_probe(timer, "rwkv6_scan_log", K.rwkv6_scan_log,
                     K.rwkv6_scan_plain, (r, k, v, logw, u), check=check)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--lib", default=None,
                    help="a kernels library to load in place of the tree's build")
    ap.add_argument("--kernels", nargs="+", default=["ssd_scan", "rwkv6_scan_log"],
                    choices=["ssd_scan", "rwkv6_scan_log"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.sellp_probe import device_ms

    if args.lib:
        _build._LIB = ctypes.CDLL(args.lib)
        _build._LIB.repro_error_string.argtypes = [ctypes.c_int]
        _build._LIB.repro_error_string.restype = ctypes.c_char_p
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def timer(fn):
        return device_ms(fn, flush)

    # a library loaded with --lib may be a deliberately altered variant
    # (an A/B of one part's cost): it is timed, not held to the plain version
    probes = {"ssd_scan": probe_ssd, "rwkv6_scan_log": probe_rwkv6}
    result = {"card": card, "lib": args.lib}
    for name in args.kernels:
        result[name] = probes[name](timer, check=args.lib is None)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
