"""SELL-P SpMV: the wrapper of the CUDA kernel ``csrc/spmv_sellp.cu`` and its
plain PyTorch version.

``spmv_sellp`` launches the kernel for CUDA tensors and counts the launch in
``spmv_sellp.launches``; for CPU tensors it returns the plain version.  There
is no fallback from a failed build or launch: the error propagates.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._check import on_cuda, require

__all__ = ["spmv_sellp", "spmv_sellp_plain", "sellp_slice_of_column"]

_P = ctypes.c_void_p
_ENTRY = {torch.float32: "repro_spmv_sellp_f32",
          torch.float64: "repro_spmv_sellp_f64"}
_ARGS = (_P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, _P)


def sellp_slice_of_column(slice_sets: torch.Tensor, columns: int) -> torch.Tensor:
    """``(columns,)`` int64: the slice each stored column of the flat buffer
    (each group of C entries) belongs to."""
    widths = (slice_sets[1:] - slice_sets[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(widths.numel(), device=slice_sets.device), widths,
        output_size=columns)


def spmv_sellp_plain(col_idx: torch.Tensor, values: torch.Tensor,
                     slice_sets: torch.Tensor, x: torch.Tensor, m: int,
                     slice_size: int) -> torch.Tensor:
    """y = A x: one flat gather-multiply, then each slice's columns summed
    into its C rows."""
    C = slice_size
    S = slice_sets.numel() - 1
    contrib = (values * x[col_idx]).view(-1, C)
    slice_of = sellp_slice_of_column(slice_sets, contrib.shape[0])
    y = torch.zeros((S, C), dtype=contrib.dtype, device=values.device)
    return y.index_add_(0, slice_of, contrib).view(-1)[:m]


def check_sellp(name: str, col_idx, values, slice_sets, x, m: int,
                slice_size: int) -> None:
    require(values.dtype in _ENTRY, name, f"values dtype {values.dtype} "
            f"not in {sorted(map(str, _ENTRY))}")
    require(x.dtype == values.dtype, name, f"x dtype {x.dtype} != {values.dtype}")
    require(col_idx.dtype == torch.int32 and slice_sets.dtype == torch.int32,
            name, "col_idx and slice_sets must be int32")
    require(values.ndim == 1 and col_idx.shape == values.shape, name,
            f"col_idx {tuple(col_idx.shape)} / values {tuple(values.shape)} "
            "must be equal flat buffers")
    require(slice_size >= 1 and values.numel() % slice_size == 0, name,
            f"{values.numel()} stored entries are not whole columns of "
            f"{slice_size}")
    require(slice_sets.ndim == 1
            and slice_sets.numel() == -(-m // slice_size) + 1, name,
            f"slice_sets has {slice_sets.numel()} offsets for {m} rows in "
            f"slices of {slice_size}")
    require(x.ndim == 1, name, f"x must be 1-D, got shape {tuple(x.shape)}")
    require(x.shape[0] > 0 or values.numel() == 0, name,
            "empty x with stored entries (padding gathers x[0])")


def spmv_sellp(col_idx: torch.Tensor, values: torch.Tensor,
               slice_sets: torch.Tensor, x: torch.Tensor, m: int,
               slice_size: int, *, block_threads: int = 256,
               wide_cols: int = 64) -> torch.Tensor:
    """y = A x for a SELL-P matrix given as its flat buffers and offsets.

    A slice of more than ``wide_cols`` columns is walked by the whole block
    (its columns split over ``block_threads // slice_size`` thread groups),
    a narrower one by one thread per row."""
    name = "spmv_sellp"
    check_sellp(name, col_idx, values, slice_sets, x, m, slice_size)
    if not on_cuda(name, col_idx, values, slice_sets, x):
        return spmv_sellp_plain(col_idx, values, slice_sets, x, m, slice_size)
    require(32 <= block_threads <= 1024 and block_threads % 32 == 0, name,
            f"block_threads {block_threads} must be a multiple of 32 in [32, 1024]")
    require(wide_cols >= 0, name, f"wide_cols {wide_cols} must be >= 0")
    y = torch.empty(m, dtype=values.dtype, device=values.device)
    if m:
        fn = _build.function(_ENTRY[values.dtype], _ARGS)
        _build.check(name, fn(
            col_idx.data_ptr(), values.data_ptr(), slice_sets.data_ptr(),
            x.data_ptr(), y.data_ptr(), m, slice_size, block_threads,
            min(wide_cols, 2**31 - 1), _build.stream_of(x)))
        spmv_sellp.launches += 1
    return y


spmv_sellp.launches = 0
