"""RMSNorm: the wrapper of the CUDA kernel ``csrc/rmsnorm.cu`` and its plain
PyTorch version.

``rmsnorm`` launches the kernel for CUDA tensors and counts the launch in
``rmsnorm.launches``; for CPU tensors it returns the plain version.  x's
rows may sit further apart than their width (a view of wider rows, such as
MLA's latent columns of the kv projection: the kernel takes the row
stride); the result is contiguous.  There is
no fallback from a failed build or launch: the error propagates.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _cost
from repro_torch.kernels._check import on_cuda, require

__all__ = ["rmsnorm", "rmsnorm_plain", "rmsnorm_geometry", "row_stride",
           "VEC_PER_THREAD"]

_P = ctypes.c_void_p
_ENTRY = {
    (torch.float32, torch.float32): "repro_rmsnorm_f32_f32",
    (torch.bfloat16, torch.bfloat16): "repro_rmsnorm_bf16_bf16",
    (torch.bfloat16, torch.float32): "repro_rmsnorm_bf16_f32",
    (torch.float16, torch.float16): "repro_rmsnorm_f16_f16",
    (torch.float16, torch.float32): "repro_rmsnorm_f16_f32",
}
_ARGS = (_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, _P)

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
    """y = x / rms(x) * w over the last axis, computed in f32 (in f64 for
    f64 inputs), in x's dtype."""
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(ct)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.to(ct)).to(x.dtype)


def row_stride(x: torch.Tensor):
    """Elements between consecutive rows of ``x`` (rows: every index of the
    leading axes, in order) when its last axis has unit stride and its
    leading axes walk the rows at one stride of at least the width; None
    otherwise.  A contiguous tensor gives its width."""
    d = x.shape[-1]
    if d > 1 and x.stride(-1) != 1:
        return None
    ld = span = None
    for size, stride in reversed(list(zip(x.shape[:-1], x.stride()[:-1]))):
        if size == 1:
            continue
        if ld is None:
            ld, span = stride, stride * size
        elif stride != span:
            return None
        else:
            span *= size
    if ld is None:
        return d
    return ld if ld >= d else None


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
    """RMSNorm over the last axis of ``x`` (any leading shape whose rows
    :func:`row_stride` can walk), scale ``w`` (d,) in x's dtype or f32; the
    result has x's dtype and is contiguous."""
    name = "rmsnorm"
    require(x.ndim >= 1 and x.shape[-1] >= 1, name,
            f"x needs a non-empty last axis, got shape {tuple(x.shape)}")
    d = x.shape[-1]
    require(w.shape == (d,), name, f"w shape {tuple(w.shape)} != ({d},)")
    require((x.dtype, w.dtype) in _ENTRY, name,
            f"dtypes (x {x.dtype}, w {w.dtype}) not in "
            f"{sorted((str(a), str(b)) for a, b in _ENTRY)}")
    ld = row_stride(x)
    require(ld is not None, name, "x's rows must be contiguous, at one stride "
            f"(shape {tuple(x.shape)}, strides {tuple(x.stride())})")
    if _cost.recording():
        return _cost.unit(name, (x, w), torch.empty(x.shape, dtype=x.dtype,
                                                    device=x.device),
                          4 * x.numel())
    if not on_cuda(name, w, strided=(x,)):
        return rmsnorm_plain(x, w, eps)
    require(1 <= rows_per_block <= MAX_THREADS // 32, name,
            f"rows_per_block {rows_per_block} must be in "
            f"[1, {MAX_THREADS // 32}]")
    aligned = x.data_ptr() % 16 == 0 and ld * x.element_size() % 16 == 0
    vectorized, per_thread, tpr, rpb = rmsnorm_geometry(
        d, x.element_size(), aligned, rows_per_block)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows = x.numel() // d
    if rows:
        fn = _build.function(_ENTRY[(x.dtype, w.dtype)], _ARGS)
        _build.check(name, fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), rows,
                              ld, d, float(eps), int(vectorized), per_thread,
                              tpr, rpb,
                              _build.stream_of(x)))
        rmsnorm.launches += 1
    return y


rmsnorm.launches = 0
