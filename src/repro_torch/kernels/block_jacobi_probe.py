"""Times ``block_jacobi_apply`` at every shape of the paths, beside its
yardsticks.

    PYTHONPATH=src python -m repro_torch.kernels.block_jacobi_probe
        [--out PATH] [--geometry]

The shapes (``SHAPES``): 262,144 blocks of 8 (``poisson_3d(128)``'s
block-Jacobi, the main path) with f32 vectors and fp16, bf16 and f32
blocks and with f64 vectors and f64, fp16 and bf16 blocks; 131,072 blocks
of 8 in f32 (the AMG check's block-Jacobi baseline on ``poisson_2d(1024)``);
2,097,152 blocks of 8 in f32 (the batched CG at 16,384 x 1,024); 65,536
blocks of 4 in f32 (a serve lane's 256 x 1,024).

At each: the kernel with the tuning spec's geometry, held against its plain
version within 2 bs eps of max_b,i sum_j |inv_bij v_bj| (eps of the
vector's type) and repeated bit for bit; the first design of the kernel
(one thread a row, ``block_jacobi/rowwise.cu``), where it
had the pair; one ``torch.bmm`` on the blocks in the vector's type (with
reduced storage the library needs a cast first: the cast, the product and
the two together are timed); the plain version.  Each time is the median
of 30 CUDA-event runs with the L2 flushed before each.  The kernel's and
the first design's own device time in µs under ``torch.profiler`` (CUPTI)
stand beside, without the ≈3 µs of the event pair, after the same flush
(64 MB written: L2 left full of dirty lines) and after one that leaves L2
clean (64 MB read).  The bound is the bytes (blocks in their storage, v
and y once each) at 3.35 TB/s.

``--geometry`` times the kernel at each ``block_threads`` of 128, 256, 512 and 1,024 at every
shape.  Prints the card's name and power
limit first and one JSON object last (also written to ``--out``); exits
non-zero without a CUDA device or when a kernel disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

#: (label, blocks, block size, vector dtype, storage dtype)
SHAPES = (
    ("main fp16", 262_144, 8, "float32", "float16"),
    ("main bf16", 262_144, 8, "float32", "bfloat16"),
    ("main f32", 262_144, 8, "float32", "float32"),
    ("main f64", 262_144, 8, "float64", "float64"),
    ("main f64 / fp16", 262_144, 8, "float64", "float16"),
    ("main f64 / bf16", 262_144, 8, "float64", "bfloat16"),
    ("AMG f32", 131_072, 8, "float32", "float32"),
    ("batched f32", 2_097_152, 8, "float32", "float32"),
    ("serve lane f32", 65_536, 4, "float32", "float32"),
)

ROWWISE_SRC = Path(__file__).resolve().parent / "block_jacobi" / "rowwise.cu"

_SHORT = {"float32": "f32", "float64": "f64", "float16": "f16",
          "bfloat16": "bf16"}
_P = ctypes.c_void_p


def rowwise_path() -> Path:
    from repro_torch.kernels import _build

    h = hashlib.sha256(ROWWISE_SRC.read_bytes())
    for p in sorted(_build.CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    h = h.hexdigest()[:16]
    return _build.BUILD_DIR / f"libblock_jacobi_rowwise_{h}.so"


def build_rowwise() -> Path:
    """Compile ``rowwise.cu`` into its own library (a few seconds), unless
    it is built already."""
    from repro_torch.kernels import _build

    out = rowwise_path()
    if out.is_file():
        return out
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        staged = Path(tmp) / out.name
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.LINK_FLAGS,
               "-I", str(_build.CSRC), "-o", str(staged), str(ROWWISE_SRC)]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {ROWWISE_SRC.name}:\n"
                               f"{r.stdout}{r.stderr}")
        (_build.BUILD_DIR / (out.name + ".log")).write_text(r.stdout + r.stderr)
        os.replace(staged, out)
    return out


class Rowwise:
    """The first design's C entries."""

    def __init__(self):
        self.lib = ctypes.CDLL(str(build_rowwise()))

    def __call__(self, inv, vp, block_threads: int = 256):
        """A callable of no arguments that runs the first design on
        ``inv``, ``vp`` (None where it lacks the pair)."""
        name = (f"repro_bj_rowwise_{_SHORT[str(vp.dtype)[6:]]}_"
                f"{_SHORT[str(inv.dtype)[6:]]}")
        fn = getattr(self.lib, name, None)
        if fn is None:
            return None
        fn.argtypes = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, _P]
        fn.restype = ctypes.c_int

        def run():
            y = torch.empty_like(vp)
            _check("rowwise", fn(inv.data_ptr(), vp.data_ptr(), y.data_ptr(),
                                 vp.shape[0], vp.shape[1], block_threads,
                                 torch.cuda.current_stream().cuda_stream))
            return y
        return run


def _check(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name} failed with CUDA error {status}")


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_ms(fn, flush, reps: int = 30) -> float:
    """Median of ``reps`` CUDA-event runs, the L2 flushed before each."""
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


def kernel_us(fn, flush, clean: bool = False):
    """Device µs of ``fn``'s own kernels (CUPTI), up to three windows (the
    profiler may drop one), else None.  The L2 is flushed before each call
    by writing 64 MB (``flush.zero_``, as the event times: L2 left full of
    dirty lines, which the call's reads must write back first) or, with
    ``clean``, by reading them (L2 left full of clean lines)."""
    from repro_torch.kernels.ell_norm_probe import _kernel_us

    before = (lambda: flush.sum(dtype=torch.int32)) if clean else flush.zero_
    for _ in range(3):
        us = _kernel_us(fn, before)
        if us == us:
            return us
    return None


def inputs(nb: int, bs: int, vec: str, storage: str, seed: int = 7):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    inv = torch.randn(nb, bs, bs, generator=gen, device="cuda",
                      dtype=torch.float64).to(getattr(torch, storage))
    vp = torch.randn(nb, bs, generator=gen, device="cuda",
                     dtype=torch.float64).to(getattr(torch, vec))
    return inv, vp


def hold(name: str, got, inv, vp) -> float:
    """max |got - plain| against 2 bs eps max_b,i sum_j |inv_bij v_bj|; the
    error, or exit when it is past the tolerance or not finite."""
    from repro_torch import kernels as K

    want = K.block_jacobi_apply_plain(inv, vp)
    err = float((got - want).abs().max())
    scale = float(K.block_jacobi_apply_plain(inv.to(vp.dtype).abs(),
                                             vp.abs()).max())
    tol = 2 * vp.shape[1] * torch.finfo(vp.dtype).eps * scale
    if not err <= tol or not bool(torch.isfinite(got).all()):
        _fail(f"{name}: max_abs_err {err} past {tol}")
    return err


def geometry(ex, nb: int, bs: int) -> dict:
    return {"block_threads": ex.launch_config(
        "block_jacobi", {"nb": nb, "bs": bs})["block_threads"]}


def bound_ms(nb: int, bs: int, vec, storage) -> tuple:
    from repro_torch.core.params import H100

    nbytes = (nb * bs * bs * storage.itemsize + 2 * nb * bs * vec.itemsize)
    return nbytes, nbytes / H100.hbm_bandwidth * 1e3


def shape_row(rowwise, ex, flush, label, nb, bs, vec, storage) -> dict:
    """The kernel, its first design and the library at one shape (see the
    module docstring)."""
    from repro_torch import kernels as K

    inv, vp = inputs(nb, bs, vec, storage)
    geo = geometry(ex, nb, bs)
    kern = lambda: K.block_jacobi_apply(inv, vp, **geo)  # noqa: E731
    y = kern()
    err = hold(f"block_jacobi_apply ({label})", y, inv, vp)
    if not torch.equal(kern(), y):
        _fail(f"block_jacobi_apply ({label}): a repeat differs")
    nbytes, bound = bound_ms(nb, bs, vp.dtype, inv.dtype)
    row = {"shape": label, "blocks": nb, "bs": bs, "vector": vec,
           "storage": storage, **geo,
           "max_abs_err": err, "bytes": nbytes, "bound_ms": bound,
           "ms": device_ms(kern, flush), "kernel_us": kernel_us(kern, flush),
           "kernel_us_clean_l2": kernel_us(kern, flush, clean=True)}
    first = rowwise(inv, vp)
    if first is None:
        row["first_design"] = "refused: it had no entry for this pair"
    else:
        hold(f"first design ({label})", first(), inv, vp)
        row.update(first_design_ms=device_ms(first, flush),
                   first_design_us=kernel_us(first, flush),
                   first_design_us_clean_l2=kernel_us(first, flush,
                                                      clean=True))
    col = vp[:, :, None]
    up = inv.to(vp.dtype)
    row["bmm_ms"] = device_ms(lambda: torch.bmm(up, col), flush)
    if inv.dtype != vp.dtype:
        row["cast_ms"] = device_ms(lambda: inv.to(vp.dtype), flush)
        row["cast_bmm_ms"] = device_ms(
            lambda: torch.bmm(inv.to(vp.dtype), col), flush)
    row["plain_ms"] = device_ms(lambda: K.block_jacobi_apply_plain(inv, vp),
                                flush)
    row["share_of_bound"] = (bound / (row["kernel_us"] * 1e-3)
                             if row["kernel_us"] else None)
    print(f"[block_jacobi] {json.dumps(row)}", flush=True)
    return row


def geometry_rows(ex, flush) -> list:
    """CUPTI µs of the kernel at 128, 256, 512 and 1,024 threads a block."""
    from repro_torch import kernels as K

    out = []
    for label, nb, bs, vec, storage in SHAPES:
        inv, vp = inputs(nb, bs, vec, storage)
        for bt in (128, 256, 512, 1024):
            fn = lambda: K.block_jacobi_apply(  # noqa: E731
                inv, vp, block_threads=bt)
            hold(f"block_jacobi_apply ({label}, {bt} threads)", fn(), inv, vp)
            rec = {"shape": label, "block_threads": bt,
                   "us": kernel_us(fn, flush)}
            print(f"[block_jacobi] geometry {json.dumps(rec)}", flush=True)
            out.append(rec)
    return out


def registers(log: str) -> list:
    """Registers and spilled bytes of each instantiation of the kernel and
    of its first design, from ``nvcc -Xptxas -v`` output (a library already
    built gives none)."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        spill = int(m.group(1)) if m else None
        m = re.search(r"Used (\d+) registers", line)
        if name and re.search("block_jacobi_(wide_)?kernel|rowwise_kernel",
                              name):
            if spill is not None:
                out.append({"kernel": name, "spill_bytes": spill})
            if m and out and out[-1]["kernel"] == name:
                out[-1]["registers"] = int(m.group(1))
    return out


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--geometry", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        _fail("no CUDA device: the probe times the kernel on the card")
    from repro_torch.core import make_executor
    from repro_torch.kernels import _build

    name = card()
    print(name, flush=True)
    ex = make_executor("cuda")
    _build.load()
    rowwise = Rowwise()
    vlog = _build.BUILD_DIR / (rowwise_path().name + ".log")
    logs = (str(_build.last_build.get("log", "")) + "\n"
            + (vlog.read_text() if vlog.is_file() else ""))
    regs = registers(logs)
    for rec in regs:
        print(f"[ptxas] {json.dumps(rec)}", flush=True)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    result = {"card": name, "registers": regs, "shapes": [
        shape_row(rowwise, ex, flush, *s) for s in SHAPES]}
    if args.geometry:
        result["geometry"] = geometry_rows(ex, flush)
    text = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
