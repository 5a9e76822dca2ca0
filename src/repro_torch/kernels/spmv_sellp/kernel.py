"""SELL-P SpMV: the wrapper of the CUDA kernel ``csrc/spmv_sellp.cu`` and its
plain PyTorch version.

``spmv_sellp`` launches the kernel for CUDA tensors and counts the launch in
``spmv_sellp.launches`` (one an apply); for CPU tensors it returns the plain
version.  The shares of slices cut by a range boundary and the tickets that
elect the warp adding them live in a cached workspace (:mod:`._workspace`).
There is no fallback from a failed build or launch: the error propagates.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, _cost, _workspace
from repro_torch.kernels._check import on_cuda, require

__all__ = ["spmv_sellp", "spmv_sellp_plain", "sellp_slice_of_column",
           "sellp_geometry", "range_cols", "resident_warps"]

_P = ctypes.c_void_p
_ENTRY = {torch.float32: "repro_spmv_sellp_f32",
          torch.float64: "repro_spmv_sellp_f64"}
_ARGS = (_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, _P)
_WARPS_ARGS = (ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.POINTER(ctypes.c_longlong))


#: the source's warp width (kWarp), the warp steps its ring of the stream
#: holds (kStages) and its __launch_bounds__' threads
WARP = 32
RING_STAGES = 4
MAX_BLOCK_THREADS = 512
#: threads a block: the sweep of kernels/sellp_probe.py on the path matrix
#: (the tuning seed, and the wrapper's default)
BLOCK_THREADS = 256
#: ranges a resident warp, and the fewest stored slots a range (a range
#: costs its warp a search, a ring to fill and maybe a ticket: at the path
#: matrix 4 ranges a warp took 12 % longer than 2, at scale 23 1 took 8 %
#: longer, its last warps finishing alone)
RANGES_PER_WARP = 2
MIN_RANGE_SLOTS = 2048


def range_cols(slice_size: int, total: int, warps: int) -> int:
    """Stored columns a range of the walk: the ``total`` stored columns cut
    into RANGES_PER_WARP ranges for each of the ``warps`` a wave holds,
    each of at least MIN_RANGE_SLOTS slots."""
    C = int(slice_size)
    return max(-(-MIN_RANGE_SLOTS // C),
               -(-int(total) // (RANGES_PER_WARP * max(int(warps), 1))))


def sellp_geometry(slice_size: int, slice_sets=None, R=None,
                   itemsize: int = 4) -> dict:
    """The walk ``csrc/spmv_sellp.cu`` derives from C (and, given them, the
    slices and the range size).

    ``vec`` slots a lane copies at once (4 when C is a multiple of 4 and the
    buffers are 16-byte aligned, as the format's are; else 1),
    ``lanes_per_col`` lanes a column, ``cols_per_step`` columns a warp step,
    ``passes`` over a range (columns of more than 32 lane-loads are walked 32
    at a time), ``smem_per_thread`` bytes of shared memory a thread of the
    block brings for ``itemsize``-byte values: its slots of the warp's ring
    of RING_STAGES steps, and, with several columns a step, its share of the
    warp's tile of row partials.  Given ``slice_sets`` (host or device, int)
    and ``R`` stored columns a range (:func:`range_cols`, as the wrapper sets
    it), also ``range_cols`` (R), ``ranges`` (the warps' ranges, each a
    ticket and two shares of C rows in the workspace) and ``carries``: the
    slices cut by a range boundary, whose rows the last of their ranges adds
    up."""
    C = int(slice_size)
    vec = 4 if C % 4 == 0 else 1
    lanes = C // vec
    lanes_per_col = min(lanes, WARP)
    cols_per_step = WARP // lanes_per_col
    ring = RING_STAGES * vec * (4 + itemsize)
    geo = {
        "vec": vec,
        "lanes_per_col": lanes_per_col,
        "cols_per_step": cols_per_step,
        "passes": -(-lanes // WARP),
        "smem_per_thread": ring + (vec * itemsize if cols_per_step > 1 else 0),
    }
    if slice_sets is not None and R is not None:
        if isinstance(slice_sets, torch.Tensor):
            slice_sets = slice_sets.cpu().numpy()
        ss = np.asarray(slice_sets, dtype=np.int64)
        R = int(R)
        lo, hi = ss[:-1], ss[1:]
        cut = (hi > lo) & (lo // R != (hi - 1) // R)
        geo["range_cols"] = R
        geo["ranges"] = int(-(-int(ss[-1]) // R))
        geo["carries"] = int(cut.sum())
    return geo


_RESIDENT: dict = {}


def resident_warps(col_idx: torch.Tensor, values: torch.Tensor,
                   slice_size: int, block_threads: int) -> int:
    """The warps one full wave of the walk holds on ``values``' card for
    blocks of ``block_threads`` (the kernel's occupancy there, asked of the
    card once a geometry); 4-slot lane-loads where C is a multiple of 4 and
    both buffers are 16-byte aligned, as the kernel picks."""
    aligned = (col_idx.data_ptr() | values.data_ptr()) % 16 == 0
    vec = 4 if slice_size % 4 == 0 and aligned else 1
    key = (values.device, values.element_size(), int(slice_size), vec,
           int(block_threads))
    warps = _RESIDENT.get(key)
    if warps is None:
        out = ctypes.c_longlong(0)
        with torch.cuda.device(values.device):
            _build.check("spmv_sellp", _build.function(
                "repro_spmv_sellp_resident_warps", _WARPS_ARGS)(
                    values.element_size(), slice_size, vec, block_threads,
                    ctypes.byref(out)))
        warps = _RESIDENT[key] = int(out.value)
    return warps


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
    into its C rows, a slice at a time in column order (a segment sum: no
    atomics, so a repeat on the card is bitwise equal)."""
    contrib = (values * x[col_idx]).view(-1, slice_size)
    return torch.segment_reduce(contrib, "sum", offsets=slice_sets,
                                axis=0).view(-1)[:m]


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
               slice_size: int, *,
               block_threads: int = BLOCK_THREADS) -> torch.Tensor:
    """y = A x for a SELL-P matrix given as its flat buffers and offsets.

    The stored columns are cut into ranges whatever the slice boundaries
    (:func:`range_cols`: a few ranges for each warp of one full wave of
    ``block_threads``-thread blocks); the wave streams them through a ring
    in shared memory, a warp a range at a time, and a slice cut by a range
    boundary is added up by the last of its ranges to finish, in range
    order (:func:`sellp_geometry`)."""
    name = "spmv_sellp"
    check_sellp(name, col_idx, values, slice_sets, x, m, slice_size)
    if _cost.recording():
        return _cost.unit(name, (col_idx, values, slice_sets, x),
                          values.new_empty(m), 2 * values.numel())
    if not on_cuda(name, col_idx, values, slice_sets, x):
        return spmv_sellp_plain(col_idx, values, slice_sets, x, m, slice_size)
    require(32 <= block_threads <= MAX_BLOCK_THREADS and block_threads % 32 == 0,
            name, f"block_threads {block_threads} must be a multiple of 32 in "
            f"[32, {MAX_BLOCK_THREADS}]")
    total = values.numel() // slice_size
    if not m or not total:
        return torch.zeros(m, dtype=values.dtype, device=values.device)
    require(total < 2 ** 31, name, f"{total} stored columns must be below 2^31")
    y = torch.empty(m, dtype=values.dtype, device=values.device)
    R = range_cols(slice_size, total, resident_warps(col_idx, values,
                                                     slice_size, block_threads))
    ranges = -(-total // R)
    stream = _build.stream_of(x)
    tickets, slots = _workspace.workspace(
        name, values.device, stream, ranges,
        2 * ranges * slice_size * values.element_size())
    fn = _build.function(_ENTRY[values.dtype], _ARGS)
    _build.check(name, fn(
        col_idx.data_ptr(), values.data_ptr(), slice_sets.data_ptr(),
        x.data_ptr(), y.data_ptr(), slots.data_ptr(), tickets.data_ptr(), m,
        slice_size, total, R, block_threads, stream))
    spmv_sellp.launches += 1
    return y


spmv_sellp.launches = 0
