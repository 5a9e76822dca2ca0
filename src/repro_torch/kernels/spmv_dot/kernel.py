"""Fused ELL SpMV + dot: the wrapper of ``csrc/spmv_dot.cu`` and its plain
PyTorch version.

``spmv_dot_ell`` launches one kernel for CUDA tensors and counts it in
``spmv_dot_ell.launches``; for CPU tensors it returns the plain version.  The
dot stays a 0-d tensor on the device, written by the kernel itself (no fill
of the result); the blocks' partials and the ticket that elects the last
block live in a cached workspace (:mod:`._workspace`); m = 0 gives a zero
dot without a launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _cost, _workspace
from repro_torch.kernels._check import on_cuda, require
from repro_torch.kernels.spmv_ell.kernel import (
    ROWS_WALK_MAX_K,
    ROWS_WALK_THREADS,
    check_ell,
    check_geometry,
    spmv_ell_plain,
)

__all__ = ["spmv_dot_ell", "spmv_dot_ell_plain"]

_P = ctypes.c_void_p
_ENTRY = {torch.float32: "repro_spmv_dot_ell_f32",
          torch.float64: "repro_spmv_dot_ell_f64"}
_ARGS = (_P, _P, _P, _P, _P, _P, _P, ctypes.c_int, _P, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, _P)


@functools.lru_cache(maxsize=None)
def _num_partials(m: int, k: int, block_threads: int, subgroup: int,
                  itemsize: int) -> int:
    """Blocks of the launch, one partial each (spmv_dot.cu decides: for the
    thread-per-row walk one wave of resident blocks at most)."""
    fn = _build.function("repro_spmv_dot_ell_partials",
                         (ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int))
    blocks = fn(m, k, block_threads, subgroup, itemsize)
    require(blocks >= 1, "spmv_dot_ell", f"no launch geometry for m = {m}, "
            f"k = {k}, {block_threads} threads, subgroup {subgroup}")
    return blocks


def spmv_dot_ell_plain(col_idx, values, x, w):
    """(y, w·y) with y = A x: the SpMV, then the dot."""
    y = spmv_ell_plain(col_idx, values, x)
    return y, torch.dot(w, y)


def spmv_dot_ell(col_idx: torch.Tensor, values: torch.Tensor, x: torch.Tensor,
                 w: torch.Tensor, *, block_threads: int = 256,
                 subgroup: int = 8):
    """(y, w·y) = (A x, dot) for a row-major ``(m, k)`` ELL matrix, one launch.

    ``subgroup = 1`` is ``spmv_ell``'s thread-per-row walk (``k`` at most
    ROWS_WALK_MAX_K, at most ROWS_WALK_THREADS threads a block), whose y
    equals ``spmv_ell``'s bit for bit, on a persistent grid of one wave
    (the blocks the SMs hold at once).  A power of two above 1
    is that many lanes a row, a block for every ``block_threads / subgroup
    * 4`` rows.  The dot is summed in an order fixed by the geometry: the
    same bits on every run.
    """
    name = "spmv_dot_ell"
    check_ell(name, col_idx, values, x)
    m, k = values.shape
    require(w.dtype == values.dtype and w.shape == (m,), name,
            f"w must be ({m},) {values.dtype}, got {tuple(w.shape)} {w.dtype}")
    if _cost.recording():
        return _cost.unit(name, (col_idx, values, x, w),
                          (values.new_empty(m), values.new_empty(())),
                          2 * m * k + 2 * m)
    if not on_cuda(name, col_idx, values, x, w):
        return spmv_dot_ell_plain(col_idx, values, x, w)
    check_geometry(name, block_threads, subgroup)
    require(subgroup > 1 or (k <= ROWS_WALK_MAX_K
                             and block_threads <= ROWS_WALK_THREADS),
            name, f"the thread-per-row walk (subgroup 1) takes k <= "
            f"{ROWS_WALK_MAX_K} and at most {ROWS_WALK_THREADS} threads a "
            f"block, got k = {k}, {block_threads} threads")
    y = torch.empty(m, dtype=values.dtype, device=values.device)
    if not m:
        return y, torch.zeros((), dtype=values.dtype, device=values.device)
    grid = _num_partials(m, k, block_threads, subgroup, values.element_size())
    stream = _build.stream_of(x)
    ticket, partials = _workspace.workspace(name, values.device, stream, 1,
                                            grid * values.element_size())
    d = torch.empty((), dtype=values.dtype, device=values.device)
    fn = _build.function(_ENTRY[values.dtype], _ARGS)
    _build.check(name, fn(
        col_idx.data_ptr(), values.data_ptr(), x.data_ptr(), w.data_ptr(),
        y.data_ptr(), partials.data_ptr(), ticket.data_ptr(), grid,
        d.data_ptr(), m, k, block_threads, subgroup, stream))
    spmv_dot_ell.launches += 1
    return y, d


spmv_dot_ell.launches = 0
