"""Argument checks shared by the kernel wrappers and their registry bindings."""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["on_cuda", "require", "require_cuda"]


def require(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def on_cuda(name: str, *tensors: torch.Tensor,
            strided: Sequence[torch.Tensor] = ()) -> bool:
    """True if every tensor is on one CUDA device, False if all are on the
    CPU; raises on a mix, on another device type, or on a non-contiguous
    tensor (the kernels index raw memory).  The tensors in ``strided`` may
    have any strides but a unit-stride last dimension (the kernel takes the
    other strides as arguments)."""
    devices = {t.device for t in (*tensors, *strided)}
    require(len(devices) == 1, name, f"tensors on several devices {devices}")
    (dev,) = devices
    require(dev.type in ("cpu", "cuda"), name, f"unsupported device {dev}")
    for t in tensors:
        require(t.is_contiguous(), name, "tensors must be contiguous")
    for t in strided:
        require(t.shape[-1] <= 1 or t.stride(-1) == 1, name,
                "the last dimension must have unit stride")
    return dev.type == "cuda"


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The ``cuda`` kernel space runs its kernels or raises: it does not take
    CPU tensors to the plain version.  While the cost model records kernel
    units (:mod:`repro_torch.kernels._cost`) it takes ``meta`` tensors."""
    from repro_torch.kernels import _cost

    for t in tensors:
        if t.device.type == "meta" and _cost.recording():
            continue
        if t.device.type != "cuda":
            raise ValueError(
                f"{name}: the cuda kernel space needs CUDA tensors, got a "
                f"tensor on {t.device}; use make_executor('torch') on the CPU"
            )
