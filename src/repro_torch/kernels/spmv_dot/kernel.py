"""Fused ELL SpMV + dot: the wrapper of ``csrc/spmv_dot.cu`` and its plain
PyTorch version.

``spmv_dot_ell`` launches the kernel (and its partial-sum pass) for CUDA
tensors and counts one launch in ``spmv_dot_ell.launches``; for CPU tensors
it returns the plain version.  The dot stays a 0-d tensor on the device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._check import on_cuda, require
from repro_torch.kernels.spmv_ell.kernel import (
    check_ell,
    check_geometry,
    spmv_ell_plain,
)

__all__ = ["spmv_dot_ell", "spmv_dot_ell_plain"]

_P = ctypes.c_void_p
_ENTRY = {torch.float32: "repro_spmv_dot_ell_f32",
          torch.float64: "repro_spmv_dot_ell_f64"}
_ARGS = (_P, _P, _P, _P, _P, _P, ctypes.c_int, _P, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, _P)


@functools.lru_cache(maxsize=None)
def _num_partials(m: int, block_threads: int, subgroup: int) -> int:
    """Blocks of the row kernel, one partial each (spmv_dot.cu decides)."""
    fn = _build.function("repro_spmv_dot_ell_partials",
                         (ctypes.c_longlong, ctypes.c_int, ctypes.c_int))
    return fn(m, block_threads, subgroup)


def spmv_dot_ell_plain(col_idx, values, x, w):
    """(y, w·y) with y = A x: the SpMV, then the dot."""
    y = spmv_ell_plain(col_idx, values, x)
    return y, torch.dot(w, y)


def spmv_dot_ell(col_idx: torch.Tensor, values: torch.Tensor, x: torch.Tensor,
                 w: torch.Tensor, *, block_threads: int = 256,
                 subgroup: int = 8):
    """(y, w·y) = (A x, dot) for a row-major ``(m, k)`` ELL matrix, one pass.

    The dot is summed in an order fixed by the geometry: the same bits on
    every run.
    """
    check_ell("spmv_dot_ell", col_idx, values, x)
    m, k = values.shape
    require(w.dtype == values.dtype and w.shape == (m,), "spmv_dot_ell",
            f"w must be ({m},) {values.dtype}, got {tuple(w.shape)} {w.dtype}")
    if not on_cuda("spmv_dot_ell", col_idx, values, x, w):
        return spmv_dot_ell_plain(col_idx, values, x, w)
    check_geometry("spmv_dot_ell", block_threads, subgroup)
    y = torch.empty(m, dtype=values.dtype, device=values.device)
    d = torch.zeros((), dtype=values.dtype, device=values.device)
    if m:
        grid = _num_partials(m, block_threads, subgroup)
        partials = torch.empty(grid, dtype=values.dtype, device=values.device)
        fn = _build.function(_ENTRY[values.dtype], _ARGS)
        _build.check("spmv_dot_ell", fn(
            col_idx.data_ptr(), values.data_ptr(), x.data_ptr(), w.data_ptr(),
            y.data_ptr(), partials.data_ptr(), grid, d.data_ptr(), m, k,
            block_threads, subgroup, _build.stream_of(x)))
        spmv_dot_ell.launches += 1
    return y, d


spmv_dot_ell.launches = 0
