"""The tracing switch the dispatch layer reads, and setup-time spans.

:data:`TRACING` is read on every operation call; while it is False dispatch
costs one module-attribute read.  While it is True the registry records a
:class:`~repro_torch.observability.events.DispatchEvent` per dispatch and hands
it to the tracer that :func:`get_tracer` returns, when one is installed.
A tracer is any object with ``rel_us(t_perf_counter) -> float`` and
``complete(name, ts_us, dur_us, cat=..., args=...)``.

``with span("amg.level", cat="amg", level=0): ...`` hands the installed
tracer one complete event (host clock, ``time.perf_counter``) when the block
ends.  Without a tracer it returns a shared no-op context manager: one flag
read, no allocation, no clock read.

:class:`ChromeTracer` keeps the events and writes them as a Chrome
trace-event file; an entry point's ``--trace OUT_JSON`` flag
(:func:`add_cli_flag`, :func:`enable_from_args`, :func:`export`) installs one.
"""

from __future__ import annotations

import json
import time
from typing import Any, Optional

__all__ = ["TRACING", "ChromeTracer", "add_cli_flag", "enable_from_args",
           "export", "get_tracer", "set_tracer", "span"]

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


class _NullSpan:
    """The shared no-op span returned while no tracer is installed."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """An open span: one complete event for the tracer when it closes."""

    __slots__ = ("tracer", "name", "cat", "args", "t0")

    def __init__(self, tracer, name: str, cat: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur_us = (time.perf_counter() - self.t0) * 1e6
        self.tracer.complete(self.name, self.tracer.rel_us(self.t0), dur_us,
                             cat=self.cat, args=self.args)
        return False


def span(name: str, *, cat: str = "span", **args):
    """A span context manager; the shared no-op one while tracing is off."""
    if not TRACING or _TRACER is None:
        return _NULL_SPAN
    return _Span(_TRACER, name, cat, args)


class ChromeTracer:
    """A tracer that keeps every complete event, timestamps relative to its
    creation, and writes them as Chrome trace events (``ph: "X"``)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.events = []

    def rel_us(self, t: float) -> float:
        return (t - self.t0) * 1e6

    def complete(self, name, ts_us, dur_us, cat="span", args=None) -> None:
        self.events.append({"name": name, "cat": cat, "ph": "X", "ts": ts_us,
                            "dur": dur_us, "pid": 0, "tid": 0,
                            "args": dict(args or {})})

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f, default=str)
            f.write("\n")
        return path


def add_cli_flag(parser) -> None:
    """Attach the ``--trace OUT_JSON`` flag to an entry point's parser."""
    parser.add_argument(
        "--trace", metavar="OUT_JSON", default=None,
        help="write a Chrome trace-event file of this run's dispatches and spans")


def enable_from_args(args) -> None:
    """Install a :class:`ChromeTracer` when ``--trace`` was given."""
    if getattr(args, "trace", None):
        set_tracer(ChromeTracer())


def export(path: str) -> Optional[str]:
    """Write the installed :class:`ChromeTracer`'s events to ``path``; None
    when no such tracer is installed."""
    if not isinstance(_TRACER, ChromeTracer):
        return None
    return _TRACER.export(path)
