"""Batched ELL SpMV: the wrapper of ``csrc/spmv_batch_ell.cu`` and its plain
PyTorch version.

``spmv_batch_ell`` launches the kernel for CUDA tensors and counts the
launch in ``spmv_batch_ell.launches``; for CPU tensors it returns the plain
version.  There is no fallback from a failed build or launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._check import on_cuda, require
from repro_torch.kernels.spmv_ell.kernel import check_geometry

__all__ = ["spmv_batch_ell", "spmv_batch_ell_plain"]

_P = ctypes.c_void_p
_ENTRY = {torch.float32: "repro_spmv_batch_ell_f32",
          torch.float64: "repro_spmv_batch_ell_f64"}
_ARGS = (_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P)


def spmv_batch_ell_plain(col_idx: torch.Tensor, values: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """Y[b, i] = sum_j values[b, i, j] * x[b, col_idx[i, j]]."""
    return (values * x[:, col_idx]).sum(dim=2)


def spmv_batch_ell(col_idx: torch.Tensor, values: torch.Tensor,
                   x: torch.Tensor, *, block_threads: int = 256,
                   subgroup: int = 1) -> torch.Tensor:
    """Y = A X for ``(m, k)`` shared ``col_idx``, ``(nb, m, k)`` values and
    ``(nb, n)`` X; returns ``(nb, m)``."""
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
    if not on_cuda(name, col_idx, values, x):
        return spmv_batch_ell_plain(col_idx, values, x)
    check_geometry(name, block_threads, subgroup)
    nb, m, k = values.shape
    y = torch.empty((nb, m), dtype=values.dtype, device=values.device)
    if nb * m:
        fn = _build.function(_ENTRY[values.dtype], _ARGS)
        _build.check(name, fn(
            col_idx.data_ptr(), values.data_ptr(), x.data_ptr(), y.data_ptr(),
            nb, m, k, x.shape[1], block_threads, subgroup, _build.stream_of(x)))
        spmv_batch_ell.launches += 1
    return y


spmv_batch_ell.launches = 0
