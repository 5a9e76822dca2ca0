"""SpGEMM's numeric passes: the wrappers of the three CUDA kernels in
``csrc/spgemm.cu`` and their plain versions.

* ``spgemm_expand(a_vals, idx, b_pad)`` — the expansion products
  ``a_vals[:, None] * b_pad[idx]`` of shape (T, K); ``idx`` is +1-shifted
  into ``b_pad``, whose slot 0 holds 0, so padding slots give exactly 0.
* ``csr_permute(values, order)`` — ``values[order]``, the value shuffle of a
  sparse transpose (16-byte packs where ``order`` and the output line up,
  a scalar head and tail around them; the kernel decides from the
  pointers).
* ``spgemm_merge(values, starts)`` — the sum of each run
  ``values[starts[s]:starts[s + 1]]`` (the last to the end), the merge of
  duplicate coordinates after the expansion is sorted.  Its plain version
  is the host coalesce's own ``np.add.reduceat``, whose order of additions
  (the run's first value plus numpy's pairwise sum of the rest) the kernel
  takes, so the two agree bit for bit.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
``.launches``; for CPU tensors it returns the plain version.  There is no
fallback from a failed build or launch: the error propagates.  Both kernels
compute what their plain versions compute bit for bit (one multiply, one
copy, a sum in numpy's order).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, _cost
from repro_torch.kernels._check import on_cuda, require

__all__ = ["csr_permute", "csr_permute_plain", "spgemm_expand",
           "spgemm_expand_plain", "spgemm_merge", "spgemm_merge_plain"]

_P = ctypes.c_void_p
_EXPAND = {torch.float32: "repro_spgemm_expand_f32",
           torch.float64: "repro_spgemm_expand_f64"}
_EXPAND_ARGS = (_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_int, _P)
_PERMUTE = {torch.float32: "repro_csr_permute_f32",
            torch.float64: "repro_csr_permute_f64"}
_PERMUTE_ARGS = (_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P)
_MERGE = {torch.float32: "repro_spgemm_merge_f32",
          torch.float64: "repro_spgemm_merge_f64"}
_MERGE_ARGS = (_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
               _P)


def spgemm_expand_plain(a_vals: torch.Tensor, idx: torch.Tensor,
                        b_pad: torch.Tensor) -> torch.Tensor:
    """out[t, q] = a_vals[t] * b_pad[idx[t, q]]."""
    return a_vals[:, None] * b_pad[idx]


def csr_permute_plain(values: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """out[t] = values[order[t]]."""
    return values[order]


def spgemm_merge_plain(values: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """out[s] = np.add.reduceat(values, starts)[s], on the host."""
    if starts.numel() == 0:
        return values.new_empty(0)
    out = np.add.reduceat(values.cpu().numpy(), starts.cpu().numpy())
    return torch.from_numpy(out).to(values.device)


def _check_threads(name: str, block_threads: int) -> None:
    require(32 <= block_threads <= 1024 and block_threads % 32 == 0, name,
            f"block_threads {block_threads} must be a multiple of 32 in [32, 1024]")


def spgemm_expand(a_vals: torch.Tensor, idx: torch.Tensor, b_pad: torch.Tensor,
                  *, block_threads: int = 256) -> torch.Tensor:
    """Expansion products (T, K) of a (T,) ``a_vals`` against the +1-shifted
    (T, K) gather map ``idx`` into ``b_pad`` (slot 0 = 0)."""
    name = "spgemm_expand"
    require(a_vals.dtype in _EXPAND, name, f"dtype {a_vals.dtype} not in "
            f"{sorted(map(str, _EXPAND))}")
    require(b_pad.dtype == a_vals.dtype, name,
            f"b_pad dtype {b_pad.dtype} != {a_vals.dtype}")
    require(idx.dtype == torch.int32, name, "idx must be int32")
    require(a_vals.ndim == 1 and idx.ndim == 2 and idx.shape[0] == a_vals.shape[0],
            name, f"a_vals {tuple(a_vals.shape)} / idx {tuple(idx.shape)} must "
            "be (T,) / (T, K)")
    require(b_pad.ndim == 1 and b_pad.shape[0] >= 1, name,
            "b_pad must be 1-D with the zero pad at slot 0")
    if _cost.recording():
        return _cost.unit(name, (a_vals, idx, b_pad),
                          a_vals.new_empty(idx.shape), idx.numel())
    if not on_cuda(name, a_vals, idx, b_pad):
        return spgemm_expand_plain(a_vals, idx, b_pad)
    _check_threads(name, block_threads)
    t, k = idx.shape
    out = torch.empty((t, k), dtype=a_vals.dtype, device=a_vals.device)
    if t * k:
        fn = _build.function(_EXPAND[a_vals.dtype], _EXPAND_ARGS)
        _build.check(name, fn(
            a_vals.data_ptr(), idx.data_ptr(), b_pad.data_ptr(), out.data_ptr(),
            t, k, block_threads, _build.stream_of(a_vals)))
        spgemm_expand.launches += 1
    return out


def csr_permute(values: torch.Tensor, order: torch.Tensor, *,
                block_threads: int = 256) -> torch.Tensor:
    """``values[order]`` for a 1-D ``values`` and an int32 ``order``."""
    name = "csr_permute"
    require(values.dtype in _PERMUTE, name, f"dtype {values.dtype} not in "
            f"{sorted(map(str, _PERMUTE))}")
    require(order.dtype == torch.int32, name, "order must be int32")
    require(values.ndim == 1 and order.ndim == 1, name,
            f"values {tuple(values.shape)} / order {tuple(order.shape)} must be 1-D")
    if _cost.recording():
        return _cost.unit(name, (values, order), values.new_empty(order.shape),
                          0)
    if not on_cuda(name, values, order):
        return csr_permute_plain(values, order)
    _check_threads(name, block_threads)
    nnz = order.shape[0]
    require(nnz < 2**31, name, f"nnz {nnz} must be below 2^31")
    out = torch.empty(nnz, dtype=values.dtype, device=values.device)
    if nnz:
        fn = _build.function(_PERMUTE[values.dtype], _PERMUTE_ARGS)
        _build.check(name, fn(
            values.data_ptr(), order.data_ptr(), out.data_ptr(), nnz,
            block_threads, _build.stream_of(values)))
        csr_permute.launches += 1
    return out


def spgemm_merge(values: torch.Tensor, starts: torch.Tensor, *,
                 block_threads: int = 256) -> torch.Tensor:
    """The sum of each run of ``values`` that the ascending int64 ``starts``
    open (``starts[0]`` is 0; the last run ends at the end), bitwise as
    ``np.add.reduceat(values, starts)``."""
    name = "spgemm_merge"
    require(values.dtype in _MERGE, name, f"dtype {values.dtype} not in "
            f"{sorted(map(str, _MERGE))}")
    require(starts.dtype == torch.int64, name, "starts must be int64")
    require(values.ndim == 1 and starts.ndim == 1, name,
            f"values {tuple(values.shape)} / starts {tuple(starts.shape)} must "
            "be 1-D")
    require(values.numel() > 0 or starts.numel() == 0, name,
            "runs need values")
    if _cost.recording():
        return _cost.unit(name, (values, starts),
                          values.new_empty(starts.shape),
                          values.numel() - starts.numel())
    if not on_cuda(name, values, starts):
        return spgemm_merge_plain(values, starts)
    _check_threads(name, block_threads)
    runs = starts.shape[0]
    out = torch.empty(runs, dtype=values.dtype, device=values.device)
    if runs:
        fn = _build.function(_MERGE[values.dtype], _MERGE_ARGS)
        _build.check(name, fn(
            values.data_ptr(), starts.data_ptr(), out.data_ptr(), runs,
            values.numel(), block_threads, _build.stream_of(values)))
        spgemm_merge.launches += 1
    return out


spgemm_expand.launches = 0
csr_permute.launches = 0
spgemm_merge.launches = 0
