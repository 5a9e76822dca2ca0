"""Block-Jacobi apply: the wrapper of ``csrc/block_jacobi.cu`` and its plain
PyTorch version.

``block_jacobi_apply`` launches the kernel for CUDA tensors and counts the
launch in ``block_jacobi_apply.launches`` and, under the storage dtype's name
(``"float16"``, ...), in ``block_jacobi_apply.launches_by_storage``; for CPU
tensors it returns the plain version.  Blocks may be stored in a reduced
precision (bf16/fp16 for f32 vectors) and are up-cast to the vector's dtype
inside the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _cost
from repro_torch.kernels._check import on_cuda, require

__all__ = ["block_jacobi_apply", "block_jacobi_apply_plain"]

_P = ctypes.c_void_p
#: (vector dtype, storage dtype) -> C entry
_ENTRY = {
    (torch.float32, torch.float32): "repro_block_jacobi_f32_f32",
    (torch.float32, torch.bfloat16): "repro_block_jacobi_f32_bf16",
    (torch.float32, torch.float16): "repro_block_jacobi_f32_f16",
    (torch.float64, torch.float64): "repro_block_jacobi_f64_f64",
}
_ARGS = (_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P)


def block_jacobi_apply_plain(inv_blocks: torch.Tensor,
                             vp: torch.Tensor) -> torch.Tensor:
    """y[b] = inv_blocks[b] @ vp[b], computed in vp's dtype."""
    return (inv_blocks.to(vp.dtype) * vp[:, None, :]).sum(dim=-1)


def block_jacobi_apply(inv_blocks: torch.Tensor, vp: torch.Tensor, *,
                       block_threads: int = 256) -> torch.Tensor:
    """y[b] = inv_blocks[b] @ vp[b] for ``(nb, bs, bs)`` blocks, ``(nb, bs)``
    segments."""
    name = "block_jacobi_apply"
    require((vp.dtype, inv_blocks.dtype) in _ENTRY, name,
            f"vector {vp.dtype} with storage {inv_blocks.dtype} not supported")
    require(inv_blocks.ndim == 3 and inv_blocks.shape[1] == inv_blocks.shape[2]
            and vp.shape == inv_blocks.shape[:2], name,
            f"inv_blocks {tuple(inv_blocks.shape)} / vp {tuple(vp.shape)} "
            "must be (nb, bs, bs) / (nb, bs)")
    if _cost.recording():
        return _cost.unit(name, (inv_blocks, vp), torch.empty_like(vp),
                          2 * inv_blocks.numel())
    if not on_cuda(name, inv_blocks, vp):
        return block_jacobi_apply_plain(inv_blocks, vp)
    require(32 <= block_threads <= 1024 and block_threads % 32 == 0, name,
            f"block_threads {block_threads} must be a multiple of 32 in [32, 1024]")
    nb, bs = vp.shape
    y = torch.empty_like(vp)
    if nb * bs:
        fn = _build.function(_ENTRY[(vp.dtype, inv_blocks.dtype)], _ARGS)
        _build.check(name, fn(
            inv_blocks.data_ptr(), vp.data_ptr(), y.data_ptr(), nb, bs,
            block_threads, _build.stream_of(vp)))
        block_jacobi_apply.launches += 1
        by = block_jacobi_apply.launches_by_storage
        key = str(inv_blocks.dtype).removeprefix("torch.")
        by[key] = by.get(key, 0) + 1
    return y


block_jacobi_apply.launches = 0
block_jacobi_apply.launches_by_storage = {}
