"""Fused axpy + squared norm: the wrapper of ``csrc/axpy_norm.cu`` and its
plain PyTorch version.

``axpy_norm`` launches the kernel (and its partial-sum pass) for CUDA tensors
and counts one launch in ``axpy_norm.launches``; for CPU tensors it returns
the plain version.  ``alpha`` is a 0-d tensor read on the device, so a solver
loop does not wait on the host for it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._check import on_cuda, require

__all__ = ["axpy_norm", "axpy_norm_plain"]

_P = ctypes.c_void_p
_ENTRY = {torch.float32: "repro_axpy_norm_f32", torch.float64: "repro_axpy_norm_f64"}
_ARGS = (_P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_int, _P)


def axpy_norm_plain(alpha, x, y):
    """(z, z·z) with z = alpha*x + y: the axpy, then the dot."""
    z = alpha * x + y
    return z, torch.dot(z, z)


def axpy_norm(alpha, x: torch.Tensor, y: torch.Tensor, *,
              block_threads: int = 256, grid_blocks: int = 1056):
    """(z, z·z) with z = alpha*x + y for 1-D ``x``, ``y``, in one pass."""
    name = "axpy_norm"
    require(x.dtype in _ENTRY, name, f"dtype {x.dtype} not in "
            f"{sorted(map(str, _ENTRY))}")
    require(x.ndim == 1 and y.shape == x.shape and y.dtype == x.dtype, name,
            f"x {tuple(x.shape)} {x.dtype} / y {tuple(y.shape)} {y.dtype} "
            "must be equal 1-D vectors")
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    require(alpha.numel() == 1, name, "alpha must be a scalar")
    if not on_cuda(name, x, y):
        return axpy_norm_plain(alpha, x, y)
    require(32 <= block_threads <= 1024 and block_threads % 32 == 0, name,
            f"block_threads {block_threads} must be a multiple of 32 in [32, 1024]")
    require(grid_blocks >= 1, name, "grid_blocks must be >= 1")
    n = x.shape[0]
    alpha = alpha.reshape(()).contiguous()
    z = torch.empty_like(x)
    ss = torch.zeros((), dtype=x.dtype, device=x.device)
    if n:
        grid = min(grid_blocks, -(-n // block_threads))
        partials = torch.empty(grid, dtype=x.dtype, device=x.device)
        fn = _build.function(_ENTRY[x.dtype], _ARGS)
        _build.check(name, fn(
            alpha.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(),
            partials.data_ptr(), ss.data_ptr(), n, block_threads, grid,
            _build.stream_of(x)))
        axpy_norm.launches += 1
    return z, ss


axpy_norm.launches = 0
