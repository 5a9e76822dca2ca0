"""RMSNorm: the wrapper of the CUDA kernel ``csrc/rmsnorm.cu`` and its plain
PyTorch version.

``rmsnorm`` launches the kernel for CUDA tensors and counts the launch in
``rmsnorm.launches``; for CPU tensors it returns the plain version.  There is
no fallback from a failed build or launch: the error propagates.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._check import on_cuda, require

__all__ = ["rmsnorm", "rmsnorm_plain", "rmsnorm_geometry", "VEC_PER_THREAD"]

_P = ctypes.c_void_p
_ENTRY = {
    (torch.float32, torch.float32): "repro_rmsnorm_f32_f32",
    (torch.bfloat16, torch.bfloat16): "repro_rmsnorm_bf16_bf16",
    (torch.bfloat16, torch.float32): "repro_rmsnorm_bf16_f32",
    (torch.float16, torch.float16): "repro_rmsnorm_f16_f16",
    (torch.float16, torch.float32): "repro_rmsnorm_f16_f32",
}
_ARGS = (_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P)

#: 16-byte vectors a thread may hold of each row (the kernel's V choices)
VEC_PER_THREAD = (1, 2, 4, 8)
#: threads a row's team should stay within: the fewest vectors a thread that
#: keep ceil(vectors / V) at or below this are taken (160 threads, 5 warps,
#: at the serving path's d = 5,120 and 2,560 in bf16)
TEAM_THREADS = 192
#: threads of a block (the kernel's __launch_bounds__): with 16-byte vectors,
#: and with single elements (d or the base not aligned)
MAX_THREADS = 256
MAX_THREADS_SCALAR = 1024


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """y = x / rms(x) * w over the last axis, computed in f32, in x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32)).to(x.dtype)


def rmsnorm_geometry(d: int, itemsize: int, aligned: bool,
                     rows_per_block: int):
    """``(vectorized, vectors per thread, threads per row, rows per block)``
    for rows of ``d`` elements: 16-byte vectors when ``d`` and the base
    allow; the fewest vectors a thread (of VEC_PER_THREAD) that keep a row's
    team within TEAM_THREADS threads, rounded up to whole warps (at most
    MAX_THREADS, or MAX_THREADS_SCALAR without vectors); several rows a block
    only when a row takes one warp."""
    vec = 16 // itemsize
    vectorized = aligned and d % vec == 0
    nvec = d // vec if vectorized else d
    for per_thread in VEC_PER_THREAD:
        if -(-nvec // per_thread) <= TEAM_THREADS:
            break
    tpr = 32 * -(-nvec // (32 * per_thread))
    limit = MAX_THREADS if vectorized else MAX_THREADS_SCALAR
    if tpr > limit:
        raise ValueError(
            f"rmsnorm: rows of {d} elements exceed one block's registers "
            f"({limit * VEC_PER_THREAD[-1]} "
            f"{'vectors of 16 bytes' if vectorized else 'elements'})")
    rpb = min(rows_per_block, MAX_THREADS // 32) if tpr == 32 else 1
    return vectorized, per_thread, tpr, rpb


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *,
            rows_per_block: int = 4) -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` (any leading shape), scale ``w``
    (d,) in x's dtype or f32; the result has x's dtype."""
    name = "rmsnorm"
    require(x.ndim >= 1 and x.shape[-1] >= 1, name,
            f"x needs a non-empty last axis, got shape {tuple(x.shape)}")
    d = x.shape[-1]
    require(w.shape == (d,), name, f"w shape {tuple(w.shape)} != ({d},)")
    require((x.dtype, w.dtype) in _ENTRY, name,
            f"dtypes (x {x.dtype}, w {w.dtype}) not in "
            f"{sorted((str(a), str(b)) for a, b in _ENTRY)}")
    if not on_cuda(name, x, w):
        return rmsnorm_plain(x, w, eps)
    require(1 <= rows_per_block <= MAX_THREADS // 32, name,
            f"rows_per_block {rows_per_block} must be in "
            f"[1, {MAX_THREADS // 32}]")
    vectorized, per_thread, tpr, rpb = rmsnorm_geometry(
        d, x.element_size(), x.data_ptr() % 16 == 0, rows_per_block)
    y = torch.empty_like(x)
    rows = x.numel() // d
    if rows:
        fn = _build.function(_ENTRY[(x.dtype, w.dtype)], _ARGS)
        _build.check(name, fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), rows,
                              d, float(eps), int(vectorized), per_thread,
                              tpr, rpb,
                              _build.stream_of(x)))
        rmsnorm.launches += 1
    return y


rmsnorm.launches = 0
