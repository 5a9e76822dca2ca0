"""Kernel units for the cost model (:mod:`repro_torch.launch.costmodel`).

A kernel launches through ``ctypes`` on raw pointers, so no
``TorchDispatchMode`` sees what it does.  While :func:`recording` is on, a
kernel wrapper launches nothing: it hands :func:`unit` its visible inputs,
its outputs (empty tensors on the inputs' device, ``meta`` in the cost
model) and the operations its bound counts (those of ``chip_smoke.py``), and
returns the outputs.  A unit's bytes are each input read once and each
output written once: what the kernel must move, whatever it keeps in shared
memory on the way (the JAX package's ``pallas_call`` unit).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional, Sequence

import torch

__all__ = ["recording", "record_units", "unit", "visible_bytes"]

_SINK: contextvars.ContextVar[Optional[Callable]] = contextvars.ContextVar(
    "repro_torch_kernel_units", default=None)


def recording() -> bool:
    """Whether kernel wrappers record units instead of launching."""
    return _SINK.get() is not None


@contextlib.contextmanager
def record_units(sink: Callable[[str, float, float, float], None]):
    """Inside, every kernel wrapper calls ``sink(name, input bytes, output
    bytes, operations)`` once a call and launches nothing."""
    token = _SINK.set(sink)
    try:
        yield
    finally:
        _SINK.reset(token)


def visible_bytes(tensors: Sequence[torch.Tensor]) -> float:
    """Bytes of the tensors' elements (a view counts its own elements)."""
    return float(sum(t.numel() * t.element_size() for t in tensors))


def unit(name: str, inputs: Sequence[torch.Tensor], outputs, flops: float):
    """Record one kernel call; returns ``outputs`` as the wrapper would.
    Only ``meta`` tensors are costed: on any other device the wrapper would
    hand back outputs it never computed, so this raises."""
    on = sorted({str(t.device) for t in inputs if t.device.type != "meta"})
    if on:
        raise ValueError(f"{name}: kernel units cost meta tensors only, got "
                         f"inputs on {on}")
    outs = outputs if isinstance(outputs, tuple) else (outputs,)
    _SINK.get()(name, visible_bytes(inputs), visible_bytes(outs), float(flops))
    return outputs
