"""The tracing switch the dispatch layer reads.

:data:`TRACING` is read on every operation call; while it is False dispatch
costs one module-attribute read.  While it is True the registry records a
:class:`~repro_torch.observability.events.DispatchEvent` per dispatch and hands
it to the tracer that :func:`get_tracer` returns, when one is installed.
A tracer is any object with ``rel_us(t_perf_counter) -> float`` and
``complete(name, ts_us, dur_us, cat=..., args=...)``.
"""

from __future__ import annotations

from typing import Any, Optional

__all__ = ["TRACING", "get_tracer", "set_tracer"]

#: fast-path flag read by the dispatch layer on every operation call
TRACING: bool = False

_TRACER: Optional[Any] = None


def get_tracer() -> Optional[Any]:
    """The installed tracer, or None."""
    return _TRACER


def set_tracer(tracer: Optional[Any]) -> None:
    """Install ``tracer`` and turn dispatch tracing on (None turns it off)."""
    global TRACING, _TRACER
    _TRACER = tracer
    TRACING = tracer is not None
