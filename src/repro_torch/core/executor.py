"""Executors — the paper's central abstraction, on PyTorch.

=================  =================  ========================================
Ginkgo backend     This package       Role
=================  =================  ========================================
Reference          ReferenceExecutor  sequential-semantics oracle (torch)
OpenMP             TorchExecutor      portable torch ops (the XLA slot)
CUDA               CudaExecutor       hand-written CUDA kernels for sm_90a
=================  =================  ========================================

An executor owns a hardware table, a kernel-space chain and a
:class:`~repro_torch.observability.events.DispatchLog`.  It does not move data
behind the caller's back: operations run where their tensors are, and the
``cuda`` space raises on tensors that are not on a CUDA device.

:func:`default_executor` is the CUDA executor; without a CUDA device it raises.
The CPU is reached only by asking for it: ``make_executor("torch")`` or
``make_executor("reference")`` and tensors built with ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Optional, Tuple, Union

import torch

from repro_torch.core import params as params_lib
from repro_torch.core.params import HardwareParams
from repro_torch.observability.events import DispatchLog

__all__ = [
    "Executor",
    "ReferenceExecutor",
    "TorchExecutor",
    "CudaExecutor",
    "current_executor",
    "use_executor",
    "default_executor",
    "default_device",
    "reset_default_executor",
    "make_executor",
    "synchronize",
]

Device = Union[str, torch.device, None]


class Executor:
    """Base executor: a hardware table, a kernel-space chain, a device."""

    #: kernel spaces this executor may dispatch into, in preference order
    spaces: Tuple[str, ...] = ("reference",)

    def __init__(self, hw: HardwareParams, *, strict: bool = False,
                 device: Device = "cpu"):
        self.hw = hw
        self.strict = strict
        self.device = torch.device(device)
        self.dispatch_log: DispatchLog = DispatchLog()
        #: the LaunchConfig of the last ``launch_config`` call (a traced
        #: dispatch clears it first and records what the kernel resolved)
        self._last_launch_config = None

    @property
    def name(self) -> str:
        return f"{type(self).__name__}({self.hw.name})"

    @property
    def kernel_space(self) -> str:
        return self.spaces[0]

    @property
    def dispatch_events(self):
        """Structured dispatch events (filled only while tracing)."""
        return self.dispatch_log.events

    def launch_config(self, op_name: str, shapes):
        """Tile geometry for ``op_name`` at ``shapes`` on this target."""
        from repro_torch.core import tuning

        cfg = tuning.resolve(op_name, shapes, self.hw)
        self._last_launch_config = cfg
        return cfg

    @contextlib.contextmanager
    def activate(self):
        """Make this the ambient executor for registered-op dispatch."""
        token = _CURRENT.set(self)
        try:
            yield self
        finally:
            _CURRENT.reset(token)

    def __repr__(self) -> str:
        return self.name


class ReferenceExecutor(Executor):
    """Sequential-semantics oracle: plain torch, no kernels."""

    spaces = ("reference",)

    def __init__(self, hw: HardwareParams = params_lib.CPU_REFERENCE, **kw):
        super().__init__(hw, **kw)


class TorchExecutor(Executor):
    """The portable backend (Ginkgo's OpenMP slot, the JAX package's XLA)."""

    spaces = ("torch", "reference")

    def __init__(self, hw: HardwareParams = params_lib.CPU_TORCH, **kw):
        super().__init__(hw, **kw)


class CudaExecutor(Executor):
    """Hand-written CUDA kernels for Hopper (the JAX package's Pallas slot).

    Ops without a ``cuda`` kernel (BLAS-1, CSR SpMV, gathers — the JAX
    package has no Pallas kernel for them either) are served by the ``torch``
    space on the same CUDA tensors.
    """

    spaces = ("cuda", "torch", "reference")

    def __init__(self, hw: HardwareParams = params_lib.H100, *,
                 device: Device = "cuda", **kw):
        super().__init__(hw, device=device, **kw)


_CURRENT: contextvars.ContextVar[Optional[Executor]] = contextvars.ContextVar(
    "repro_torch_current_executor", default=None
)
_DEFAULT: Optional[Executor] = None


def default_device() -> torch.device:
    """The device entry points use when the caller names none: the card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (and an executor "
            "from make_executor('torch') or make_executor('reference')) to run "
            "on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def default_executor() -> Executor:
    """The CUDA executor on the current device (cached); raises without CUDA."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = CudaExecutor(device=default_device())
    return _DEFAULT


def reset_default_executor() -> None:
    """Drop the cached default executor."""
    global _DEFAULT
    _DEFAULT = None


def current_executor() -> Executor:
    ex = _CURRENT.get()
    return ex if ex is not None else default_executor()


@contextlib.contextmanager
def use_executor(ex: Executor):
    with ex.activate():
        yield ex


def synchronize(tree: Any = None) -> Any:
    """Wait for the current CUDA device's queued work (no-op without CUDA);
    returns ``tree``."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return tree


_EXECUTORS = {
    "reference": ReferenceExecutor,
    "torch": TorchExecutor,
    "cuda": CudaExecutor,
}


def make_executor(kind: str, hw: Optional[HardwareParams] = None,
                  **kw) -> Executor:
    """``kind`` is a space (``reference`` / ``torch`` / ``cuda``) or a target
    name from :data:`repro_torch.core.params.TARGETS` (``h100``, ...)."""
    if kind in _EXECUTORS:
        cls = _EXECUTORS[kind]
        return cls(hw, **kw) if hw is not None else cls(**kw)
    if kind in params_lib.TARGETS:
        target = hw or params_lib.get_target(kind)
        return _EXECUTORS[target.kernel_space](target, **kw)
    raise KeyError(
        f"unknown executor kind {kind!r}; known kinds: {sorted(_EXECUTORS)}, "
        f"targets: {sorted(params_lib.TARGETS)}"
    )
