"""ELL SpMV: the wrapper of the CUDA kernel ``csrc/spmv_ell.cu`` and its plain
PyTorch version.

``spmv_ell`` launches the kernel for CUDA tensors and counts the launch in
``spmv_ell.launches`` (and by value type, ``"float32"`` / ``"float64"``, in
``spmv_ell.launches_by_dtype``); for CPU tensors it returns the plain
version.  There
is no fallback from a failed build or launch: the error propagates.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _cost
from repro_torch.kernels._check import on_cuda, require

__all__ = ["spmv_ell", "spmv_ell_plain", "ROWS_WALK_MAX_K", "ROWS_WALK_THREADS"]

_P = ctypes.c_void_p
_ENTRY = {torch.float32: "repro_spmv_ell_f32", torch.float64: "repro_spmv_ell_f64"}
_ARGS = (_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, _P)

#: widest row the thread-per-row walk (``subgroup = 1``) takes (its gathers
#: are held in KMAX <= 32 registers a thread), and its most threads a block
#: (its __launch_bounds__)
ROWS_WALK_MAX_K = 32
ROWS_WALK_THREADS = 256


def spmv_ell_plain(col_idx: torch.Tensor, values: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_j values[i, j] * x[col_idx[i, j]] (padding adds 0)."""
    return (values * x[col_idx]).sum(dim=1)


def check_ell(name: str, col_idx, values, x) -> None:
    require(values.dtype in _ENTRY, name, f"values dtype {values.dtype} "
            f"not in {sorted(map(str, _ENTRY))}")
    require(x.dtype == values.dtype, name, f"x dtype {x.dtype} != {values.dtype}")
    require(col_idx.dtype == torch.int32, name, "col_idx must be int32")
    require(values.ndim == 2 and col_idx.shape == values.shape, name,
            f"col_idx {tuple(col_idx.shape)} / values {tuple(values.shape)} "
            "must both be (m, k)")
    require(x.ndim == 1, name, f"x must be 1-D, got shape {tuple(x.shape)}")
    require(x.shape[0] > 0 or values.numel() == 0, name,
            "empty x with stored entries (padding gathers x[0])")


def check_geometry(name: str, block_threads: int, subgroup: int) -> None:
    require(32 <= block_threads <= 1024 and block_threads % 32 == 0, name,
            f"block_threads {block_threads} must be a multiple of 32 in [32, 1024]")
    require(subgroup in (1, 2, 4, 8, 16, 32), name,
            f"subgroup {subgroup} must be a power of two <= 32")


def spmv_ell(col_idx: torch.Tensor, values: torch.Tensor, x: torch.Tensor, *,
             block_threads: int = 256, subgroup: int = 8) -> torch.Tensor:
    """y = A x for a row-major ``(m, k)`` ELL matrix given as (col_idx, values).

    ``subgroup = 1`` walks a row with one thread (a warp stages its 32 rows'
    entries in shared memory; ``k`` at most ROWS_WALK_MAX_K, at most
    ROWS_WALK_THREADS threads a block), a power of two above 1 with that
    many lanes."""
    check_ell("spmv_ell", col_idx, values, x)
    if _cost.recording():
        return _cost.unit("spmv_ell", (col_idx, values, x), values.new_empty(
            values.shape[0]), 2 * values.numel())
    if not on_cuda("spmv_ell", col_idx, values, x):
        return spmv_ell_plain(col_idx, values, x)
    check_geometry("spmv_ell", block_threads, subgroup)
    m, k = values.shape
    require(subgroup > 1 or (k <= ROWS_WALK_MAX_K
                             and block_threads <= ROWS_WALK_THREADS),
            "spmv_ell", f"the thread-per-row walk (subgroup 1) takes k <= "
            f"{ROWS_WALK_MAX_K} and at most {ROWS_WALK_THREADS} threads a "
            f"block, got k = {k}, {block_threads} threads")
    y = torch.empty(m, dtype=values.dtype, device=values.device)
    if m:
        fn = _build.function(_ENTRY[values.dtype], _ARGS)
        _build.check("spmv_ell", fn(
            col_idx.data_ptr(), values.data_ptr(), x.data_ptr(), y.data_ptr(),
            m, k, block_threads, subgroup, _build.stream_of(x)))
        spmv_ell.launches += 1
        by = spmv_ell.launches_by_dtype
        key = str(values.dtype).removeprefix("torch.")
        by[key] = by.get(key, 0) + 1
    return y


spmv_ell.launches = 0
spmv_ell.launches_by_dtype = {}
