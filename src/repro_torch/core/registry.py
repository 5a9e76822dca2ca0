"""Operation registry — the analogue of ``GKO_REGISTER_OPERATION`` + dynamic dispatch.

Algorithms never name a backend: they call an :class:`Operation`, and the
active :class:`~repro_torch.core.executor.Executor` picks which kernel space's
implementation runs.  Spaces are ``reference`` (sequential-semantics torch),
``torch`` (portable torch ops) and ``cuda`` (hand-written CUDA kernels).

* In strict mode an executor searches only its own space and a missing kernel
  raises :class:`NotCompiledError` (Ginkgo's ``gko::NotCompiled``).
* Otherwise the executor's chain is walked (``cuda -> torch -> reference``).
  The chain picks the first space that has an implementation; it never
  catches an implementation's error to try the next space.
* Every implementation receives the executor as its first argument.
* While a ``torch.profiler`` runs, each dispatch is a host range named
  ``op.<operation>``; with tracing and the profiler off that costs one flag
  read.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Tuple

from torch.autograd import profiler as _profiler

from repro_torch.observability import events as _events
from repro_torch.observability import metrics as _metrics
from repro_torch.observability import trace as _trace

__all__ = [
    "NotCompiledError",
    "Operation",
    "operation",
    "register",
    "registered_spaces",
    "all_operations",
    "instantiate_common",
]


class NotCompiledError(NotImplementedError):
    """No implementation is registered for any space the executor may use."""


_OPERATIONS: Dict[str, "Operation"] = {}


class Operation:
    """A named, executor-dispatched operation (one ``GKO_REGISTER_OPERATION``)."""

    def __init__(self, name: str, doc: str = ""):
        if name in _OPERATIONS:
            raise ValueError(f"operation {name!r} already defined")
        self.name = name
        self.range_name = "op." + name
        self.__doc__ = doc or f"executor-dispatched operation {name!r}"
        self._impls: Dict[str, Callable[..., Any]] = {}
        _OPERATIONS[name] = self

    def register(self, space: str) -> Callable[[Callable], Callable]:
        """Decorator: register ``fn(executor, *args, **kw)`` for ``space``."""

        def deco(fn: Callable) -> Callable:
            if space in self._impls:
                raise ValueError(
                    f"operation {self.name!r} already has a {space!r} kernel"
                )
            self._impls[space] = fn
            return fn

        return deco

    def _searched(self, executor) -> Tuple[str, ...]:
        return (executor.kernel_space,) if executor.strict else executor.spaces

    def resolve(self, executor) -> Tuple[str, Callable[..., Any]]:
        """``(kernel_space, implementation)`` that will serve ``executor``."""
        spaces = self._searched(executor)
        for space in spaces:
            impl = self._impls.get(space)
            if impl is not None:
                return space, impl
        raise NotCompiledError(
            f"operation {self.name!r} has no kernel for executor "
            f"{executor.name!r} (searched spaces {spaces}; "
            f"registered: {sorted(self._impls)})"
        )

    def supports(self, executor) -> bool:
        """Does any of the executor's kernel spaces serve this operation?"""
        return any(space in self._impls for space in self._searched(executor))

    def space_used(self, executor) -> str:
        """Which kernel space would serve this executor."""
        return self.resolve(executor)[0]

    def __call__(self, *args, executor=None, **kwargs):
        from repro_torch.core.executor import current_executor

        ex = executor if executor is not None else current_executor()
        space, impl = self.resolve(ex)
        if _trace.TRACING:
            return self._traced_call(ex, space, impl, args, kwargs)
        if _profiler._is_profiler_enabled:
            out = self._ranged(ex, impl, args, kwargs)
        else:
            out = impl(ex, *args, **kwargs)
        ex.dispatch_log.record(self.name)
        return out

    def _ranged(self, ex, impl, args, kwargs):
        """The call inside its ``op.<name>`` host range for the profiler."""
        with _trace.host_range(self.range_name):
            return impl(ex, *args, **kwargs)

    def _traced_call(self, ex, space, impl, args, kwargs):
        """Dispatch with a structured event: op, space, operand shapes, the
        LaunchConfig the kernel resolved and the call's host time, handed to
        the tracer and folded into the metrics registry.

        Nothing synchronises: on a card the host time is the launch's, and
        the kernel's time is read from ``torch.profiler``'s device trace,
        on whose clock the event is stamped."""
        tracer = _trace.get_tracer()
        ex._last_launch_config = None  # set again if the kernel resolves one
        t0 = _trace.now_ns()
        if _profiler._is_profiler_enabled:
            out = self._ranged(ex, impl, args, kwargs)
        else:
            out = impl(ex, *args, **kwargs)
        host_us = (_trace.now_ns() - t0) * 1e-3
        ts_us = tracer.rel_us(t0) if tracer is not None else 0.0
        event = _events.make_event(
            op=self.name,
            space=space,
            executor=ex,
            launch=ex._last_launch_config,
            host_us=host_us,
            ts_us=ts_us,
            operands=args,
        )
        ex.dispatch_log.record(self.name, event)
        if tracer is not None:
            tracer.complete(
                self.name, ts_us, host_us, cat="dispatch", args=event.to_args()
            )
        _metrics.observe_dispatch(event)
        return out

    def __repr__(self) -> str:
        return f"Operation({self.name!r}, spaces={sorted(self._impls)})"


def operation(name: str, doc: str = "") -> Operation:
    """Create (or fetch) the named operation."""
    if name in _OPERATIONS:
        return _OPERATIONS[name]
    return Operation(name, doc)


def register(name: str, space: str) -> Callable[[Callable], Callable]:
    """Shorthand: ``@register("spmv_ell", "cuda")``."""
    return operation(name).register(space)


def registered_spaces(name: str) -> tuple:
    """The kernel spaces that serve operation ``name``, sorted."""
    return tuple(sorted(_OPERATIONS[name]._impls))


def all_operations() -> Dict[str, "Operation"]:
    """Every operation defined so far, by name."""
    return dict(_OPERATIONS)


def instantiate_common(
    name: str,
    skeleton: Callable[..., Any],
    space_params: Dict[str, Dict[str, Any]],
) -> Operation:
    """Bind one skeleton ``skeleton(executor, *args, **params)`` to several
    kernel spaces, each with its own parameter dict (Ginkgo's ``common/``)."""
    op = operation(name)
    for space, params in space_params.items():
        bound = functools.partial(skeleton, **params)
        functools.update_wrapper(bound, skeleton)
        op.register(space)(bound)
    return op
