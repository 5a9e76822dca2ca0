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
         ctypes.c_int, ctypes.c_int, ctypes.c_int, _P)

#: vectors of 16 bytes each thread holds in registers (kVecPerThread)
VEC_PER_THREAD = 8


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """y = x / rms(x) * w over the last axis, computed in f32, in x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32)).to(x.dtype)


def rmsnorm_geometry(d: int, itemsize: int, aligned: bool,
                     rows_per_block: int):
    """``(vectorized, threads per row, rows per block)`` for rows of ``d``
    elements: 16-byte vectors when ``d`` and the base allow, enough threads
    of 32 for each to hold at most VEC_PER_THREAD vectors, several rows a
    block only when a row takes one warp."""
    vec = 16 // itemsize
    vectorized = aligned and d % vec == 0
    nvec = d // vec if vectorized else d
    per_thread = -(-nvec // VEC_PER_THREAD)
    tpr = 32 * -(-per_thread // 32)
    if tpr > 1024:
        raise ValueError(
            f"rmsnorm: rows of {d} elements exceed one block's registers "
            f"({1024 * VEC_PER_THREAD} vectors)")
    return vectorized, tpr, (rows_per_block if tpr == 32 else 1)


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
    require(1 <= rows_per_block <= 32, name,
            f"rows_per_block {rows_per_block} must be in [1, 32]")
    vectorized, tpr, rpb = rmsnorm_geometry(
        d, x.element_size(), x.data_ptr() % 16 == 0, rows_per_block)
    y = torch.empty_like(x)
    rows = x.numel() // d
    if rows:
        fn = _build.function(_ENTRY[(x.dtype, w.dtype)], _ARGS)
        _build.check(name, fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), rows,
                              d, float(eps), int(vectorized), tpr, rpb,
                              _build.stream_of(x)))
        rmsnorm.launches += 1
    return y


rmsnorm.launches = 0
