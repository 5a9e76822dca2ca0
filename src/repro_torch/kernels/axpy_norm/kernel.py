"""Fused axpy + squared norm: the wrappers of ``csrc/axpy_norm.cu`` and their
plain PyTorch version.

``axpy_norm`` (1-D vectors) and ``axpy_norm_rows`` (``(nb, n)`` batches, one
alpha and one squared norm per row) launch one kernel for CUDA tensors and
count it in their ``.launches``; for CPU tensors they return the plain
version.  ``alpha`` is read on the device, so a solver loop does not wait on
the host for it.  The kernel writes z.z itself (no fill of the result), and
the blocks' partials and tickets live in a cached workspace
(:mod:`._workspace`); n = 0 gives a zero without a launch.

Route: :func:`vector_width` picks 16-byte packs (4 f32 or 2 f64 elements a
load) where x, y and z are 16-byte aligned (and, for rows, n is a multiple
of the pack), single elements otherwise (an offset view such as ``x[1:]``);
:func:`launch_grid` sizes the vector form's grid from the route, and the
tuning spec clamps its ``grid_blocks`` with the same function.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _cost, _workspace
from repro_torch.kernels._check import on_cuda, require

__all__ = ["axpy_norm", "axpy_norm_plain", "axpy_norm_rows", "launch_grid",
           "rows_chunks", "vector_width"]

_P = ctypes.c_void_p
_ENTRY = {torch.float32: "repro_axpy_norm_f32", torch.float64: "repro_axpy_norm_f64"}
_ARGS = (_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, _P)
_ROWS_ENTRY = {torch.float32: "repro_axpy_norm_rows_f32",
               torch.float64: "repro_axpy_norm_rows_f64"}
_ROWS_ARGS = (_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, _P)

#: bytes one load of the pack route moves
PACK_BYTES = 16


def vector_width(*tensors: torch.Tensor, row: int = None) -> int:
    """Elements a load of the kernel moves: ``PACK_BYTES / itemsize`` where
    every tensor's data is 16-byte aligned (and ``row``, the length of a row
    of the batched form, is a multiple of it), else 1."""
    width = PACK_BYTES // tensors[0].element_size()
    aligned = all(t.data_ptr() % PACK_BYTES == 0 for t in tensors)
    return width if aligned and (row is None or row % width == 0) else 1


def launch_grid(n: int, width: int, block_threads: int, grid_blocks: int) -> int:
    """Blocks of the vector form: at most ``grid_blocks`` (one wave), and no
    more than give each thread one load of ``width`` elements."""
    packs = -(-n // width)
    return max(1, min(grid_blocks, -(-packs // block_threads)))


def axpy_norm_plain(alpha, x, y):
    """(z, z·z) with z = alpha*x + y: the axpy, then the dot.  For ``(nb, n)``
    operands alpha is a scalar or one per row, and z·z one per row."""
    if x.ndim == 2:
        a = alpha[:, None] if torch.as_tensor(alpha).ndim == 1 else alpha
        z = a * x + y
        return z, (z * z).sum(dim=1)
    z = alpha * x + y
    return z, torch.dot(z, z)


def _check_geometry(name: str, block_threads: int, grid_blocks: int) -> None:
    require(32 <= block_threads <= 1024 and block_threads % 32 == 0, name,
            f"block_threads {block_threads} must be a multiple of 32 in [32, 1024]")
    require(grid_blocks >= 1, name, "grid_blocks must be >= 1")


def axpy_norm(alpha, x: torch.Tensor, y: torch.Tensor, *,
              block_threads: int = 256, grid_blocks: int = 1056):
    """(z, z·z) with z = alpha*x + y for 1-D ``x``, ``y``, in one launch."""
    name = "axpy_norm"
    require(x.dtype in _ENTRY, name, f"dtype {x.dtype} not in "
            f"{sorted(map(str, _ENTRY))}")
    require(x.ndim == 1 and y.shape == x.shape and y.dtype == x.dtype, name,
            f"x {tuple(x.shape)} {x.dtype} / y {tuple(y.shape)} {y.dtype} "
            "must be equal 1-D vectors")
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    require(alpha.numel() == 1, name, "alpha must be a scalar")
    if _cost.recording():
        return _cost.unit(name, (alpha, x, y),
                          (torch.empty_like(x), x.new_empty(())), 4 * x.numel())
    if not on_cuda(name, x, y):
        return axpy_norm_plain(alpha, x, y)
    _check_geometry(name, block_threads, grid_blocks)
    n = x.shape[0]
    require(n < 2 ** 31, name, f"n = {n} must be below 2^31")
    z = torch.empty_like(x)
    if not n:
        return z, torch.zeros((), dtype=x.dtype, device=x.device)
    alpha = alpha.reshape(()).contiguous()
    width = vector_width(x, y, z)
    grid = launch_grid(n, width, block_threads, grid_blocks)
    stream = _build.stream_of(x)
    tickets, partials = _workspace.workspace(name, x.device, stream, 1,
                                             grid * x.element_size())
    ss = torch.empty((), dtype=x.dtype, device=x.device)
    fn = _build.function(_ENTRY[x.dtype], _ARGS)
    _build.check(name, fn(
        alpha.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(),
        partials.data_ptr(), tickets.data_ptr(), ss.data_ptr(), n,
        block_threads, grid, width, stream))
    axpy_norm.launches += 1
    return z, ss


axpy_norm.launches = 0


def rows_chunks(nb: int, n: int, block_threads: int, grid_blocks: int) -> int:
    """Pieces ``axpy_norm_rows`` cuts each row into: enough for about
    ``grid_blocks`` blocks, none shorter than a block.  Past one piece the
    row's last block adds the row's partials in a fixed order."""
    return max(1, min(-(-grid_blocks // max(nb, 1)), -(-n // block_threads)))


def axpy_norm_rows(alpha, x: torch.Tensor, y: torch.Tensor, *,
                   block_threads: int = 256, grid_blocks: int = 1056):
    """(Z, ‖Z[b]‖²) with Z = alpha[:, None] * x + y for ``(nb, n)`` x, y and
    a scalar or ``(nb,)`` alpha, each row cut into :func:`rows_chunks`
    pieces, in one launch."""
    name = "axpy_norm_rows"
    require(x.dtype in _ROWS_ENTRY, name, f"dtype {x.dtype} not in "
            f"{sorted(map(str, _ROWS_ENTRY))}")
    require(x.ndim == 2 and y.shape == x.shape and y.dtype == x.dtype, name,
            f"x {tuple(x.shape)} {x.dtype} / y {tuple(y.shape)} {y.dtype} "
            "must be equal (nb, n) batches")
    nb, n = x.shape
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    require(alpha.ndim == 0 or alpha.shape == (nb,), name,
            f"alpha {tuple(alpha.shape)} must be a scalar or ({nb},)")
    if _cost.recording():
        return _cost.unit(name, (alpha, x, y),
                          (torch.empty_like(x), x.new_empty(nb)), 4 * x.numel())
    if not on_cuda(name, x, y):
        return axpy_norm_plain(alpha, x, y)
    _check_geometry(name, block_threads, grid_blocks)
    require(n < 2 ** 31, name, f"n = {n} must be below 2^31")
    z = torch.empty_like(x)
    if not (nb and n):
        return z, torch.zeros(nb, dtype=x.dtype, device=x.device)
    alpha = alpha.expand(nb).contiguous()
    width = vector_width(x, y, z, row=n)
    chunks = rows_chunks(nb, n, block_threads, grid_blocks)
    stream = _build.stream_of(x)
    pieces = nb if chunks > 1 else 0
    tickets, partials = _workspace.workspace(
        name, x.device, stream, pieces, pieces * chunks * x.element_size())
    ss = torch.empty(nb, dtype=x.dtype, device=x.device)
    fn = _build.function(_ROWS_ENTRY[x.dtype], _ROWS_ARGS)
    _build.check(name, fn(
        alpha.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(),
        partials.data_ptr(), tickets.data_ptr(), ss.data_ptr(), nb, n,
        block_threads, chunks, width, stream))
    axpy_norm_rows.launches += 1
    return z, ss


axpy_norm_rows.launches = 0
