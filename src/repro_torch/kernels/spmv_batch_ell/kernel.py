"""Batched ELL SpMV: the wrapper of ``csrc/spmv_batch_ell.cu`` and its plain
PyTorch version.

``spmv_batch_ell`` launches the kernel for CUDA tensors and counts the
launch in ``spmv_batch_ell.launches``; for CPU tensors it returns the plain
version.  There is no fallback from a failed build or launch.

The kernel has two routes, chosen by ``subgroup``: 1 is the narrow route
(one thread a row of several systems, k at most ROWS_WALK_MAX_K); a power
of two from 2 to 32 is the wide route, that many lanes a row, each lane
holding one 16-byte pack of a row (a warp a row: up to WIDE_PACKS in the
tile kernel; a longer row takes the long walk, WIDE_PACKS packs a lane at a
time, so a warp a row takes any k).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _cost
from repro_torch.kernels._check import on_cuda, require
from repro_torch.kernels.spmv_ell.kernel import (ROWS_WALK_MAX_K,
                                                ROWS_WALK_THREADS,
                                                check_geometry)

__all__ = ["check_route", "spmv_batch_ell", "spmv_batch_ell_plain",
           "vector_loads",
           "wide_lanes", "WIDE_PACKS", "WIDE_THREADS"]

_P = ctypes.c_void_p
_ENTRY = {torch.float32: "repro_spmv_batch_ell_f32",
          torch.float64: "repro_spmv_batch_ell_f64"}
_ARGS = (_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P)

#: bytes a load of the kernels moves, and the wide route's pack slots a
#: thread (kWidePacks) and most threads a block (kWideThreads)
PACK_BYTES = 16
WIDE_PACKS = 4
WIDE_THREADS = 256


def spmv_batch_ell_plain(col_idx: torch.Tensor, values: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """Y[b, i] = sum_j values[b, i, j] * x[b, col_idx[i, j]]."""
    return (values * x[:, col_idx]).sum(dim=2)


def _packs(k: int, itemsize: int) -> int:
    """16-byte packs of one row of k values."""
    return -(-k // (PACK_BYTES // itemsize))


def wide_lanes(k: int, itemsize: int) -> int:
    """Lanes a row of the wide route: the power of two covering the row's
    16-byte packs, at most a warp."""
    n = _packs(k, itemsize)
    return min(32, 1 if n <= 1 else 1 << (n - 1).bit_length())


def vector_loads(values: torch.Tensor) -> bool:
    """Whether the wide route may load ``values`` in 16-byte packs: its base
    16-byte aligned and each row of k values a whole number of packs, so
    every row starts aligned.  Otherwise it takes single entries.  (The
    narrow route always loads single entries.)"""
    return (values.data_ptr() % PACK_BYTES == 0
            and values.shape[-1] * values.element_size() % PACK_BYTES == 0)


def check_route(k: int, itemsize: int, block_threads: int,
                subgroup: int) -> None:
    """Raises unless the route ``subgroup`` picks takes rows of k entries of
    ``itemsize`` bytes at ``block_threads`` threads a block."""
    name = "spmv_batch_ell"
    if subgroup == 1:
        require(k <= ROWS_WALK_MAX_K and block_threads <= ROWS_WALK_THREADS,
                name, f"the narrow route (subgroup 1) takes k <= "
                f"{ROWS_WALK_MAX_K} and at most {ROWS_WALK_THREADS} threads a "
                f"block, got k = {k}, {block_threads} threads")
    else:
        lane_packs = -(-_packs(k, itemsize) // subgroup)
        require((lane_packs == 1 or subgroup == 32)
                and block_threads <= WIDE_THREADS, name,
                f"the wide route takes one 16-byte pack of a row a lane (any "
                f"number with 32 lanes) and {WIDE_THREADS} threads a block, "
                f"got {lane_packs} at k = {k} with {subgroup} lanes, "
                f"{block_threads} threads")


def spmv_batch_ell(col_idx: torch.Tensor, values: torch.Tensor,
                   x: torch.Tensor, *, block_threads: int = 256,
                   subgroup: int = 1) -> torch.Tensor:
    """Y = A X for ``(m, k)`` shared ``col_idx``, ``(nb, m, k)`` values and
    ``(nb, n)`` X; returns ``(nb, m)``.  ``subgroup`` picks the route (see
    the module docstring)."""
    name = "spmv_batch_ell"
    require(values.dtype in _ENTRY, name, f"values dtype {values.dtype} "
            f"not in {sorted(map(str, _ENTRY))}")
    require(x.dtype == values.dtype, name, f"x dtype {x.dtype} != {values.dtype}")
    require(col_idx.dtype == torch.int32, name, "col_idx must be int32")
    require(values.ndim == 3 and col_idx.shape == values.shape[1:], name,
            f"col_idx {tuple(col_idx.shape)} / values {tuple(values.shape)} "
            "must be (m, k) / (nb, m, k)")
    require(x.ndim == 2 and x.shape[0] == values.shape[0], name,
            f"x {tuple(x.shape)} must be (nb, n) with nb = {values.shape[0]}")
    require(x.shape[1] > 0 or values.numel() == 0, name,
            "empty x with stored entries (padding gathers x[:, 0])")
    if _cost.recording():
        return _cost.unit(name, (col_idx, values, x),
                          values.new_empty(values.shape[:2]),
                          2 * values.numel())
    if not on_cuda(name, col_idx, values, x):
        return spmv_batch_ell_plain(col_idx, values, x)
    check_geometry(name, block_threads, subgroup)
    nb, m, k = values.shape
    n = x.shape[1]
    require(m * k < 2**31 and n < 2**31, name,
            f"a system's m k = {m * k} and n = {n} must be below 2^31")
    check_route(k, values.element_size(), block_threads, subgroup)
    y = torch.empty((nb, m), dtype=values.dtype, device=values.device)
    if nb * m:
        fn = _build.function(_ENTRY[values.dtype], _ARGS)
        _build.check(name, fn(
            col_idx.data_ptr(), values.data_ptr(), x.data_ptr(), y.data_ptr(),
            nb, m, k, n, block_threads, subgroup,
            int(subgroup > 1 and vector_loads(values)), _build.stream_of(x)))
        spmv_batch_ell.launches += 1
    return y


spmv_batch_ell.launches = 0
