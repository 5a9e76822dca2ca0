"""Span tracer with Chrome trace-event export — the ``gko::log`` analogue.

A copy of the JAX package's tracer, stdlib only:

* :data:`TRACING` is read by the dispatch layer on every operation call;
  while it is False dispatch costs one module-attribute read, and
  :func:`span` returns a shared no-op context manager (no allocation, no
  clock read).
* While it is True the registry records a
  :class:`~repro_torch.observability.events.DispatchEvent` per dispatch and
  hands the installed tracer one complete event for it.  A tracer is any
  object with ``rel_us(t_perf_counter) -> float`` and ``complete(name,
  ts_us, dur_us, cat=..., args=...)`` (``instant`` is optional);
  :class:`Tracer` is the one this module installs.
* :class:`Tracer` keeps complete ("X") and instant ("i") events and writes
  them as a Chrome trace-event file (``{"traceEvents": [...]}``, viewable in
  Perfetto), which :func:`validate_trace` checks.

Activation: ``REPRO_TRACE=1`` in the environment enables tracing at import
and exports to ``REPRO_TRACE_PATH`` (default ``repro_trace.json``) at exit;
an entry point's ``--trace OUT_JSON`` flag (:func:`add_cli_flag`,
:func:`enable_from_args`, then :func:`export`); ``with tracing(path):``; or
:func:`enable` / :func:`export` / :func:`disable`.

Host clock throughout (``time.perf_counter``).  A traced dispatch on a CUDA
executor synchronises the device around the call, so its duration covers
the device work (:meth:`repro_torch.core.registry.Operation._traced_call`).
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "TRACING",
    "Tracer",
    "ENV_FLAG",
    "ENV_PATH",
    "add_cli_flag",
    "disable",
    "enable",
    "enable_from_args",
    "enabled",
    "export",
    "get_tracer",
    "instant",
    "maybe_enable_from_env",
    "reset",
    "set_tracer",
    "span",
    "tracing",
    "validate_trace",
]

#: fast-path flag read by the dispatch layer on every operation call
TRACING: bool = False

ENV_FLAG = "REPRO_TRACE"
ENV_PATH = "REPRO_TRACE_PATH"
DEFAULT_PATH = "repro_trace.json"

_TRACER: Optional[Any] = None
_EXPORT_PATH: Optional[str] = None
_ATEXIT_REGISTERED = False
_LOCK = threading.Lock()

#: phases of the Chrome trace-event format that are emitted or accepted
_VALID_PHASES = ("X", "i", "I", "B", "E", "C", "M")


class _NullSpan:
    """The shared no-op span returned while tracing is off."""

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


class Tracer:
    """Accumulates trace events, timestamps relative to its creation."""

    def __init__(self):
        self.events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self.t0 = time.perf_counter()
        self.pid = os.getpid()

    def now_us(self) -> float:
        return (time.perf_counter() - self.t0) * 1e6

    def rel_us(self, perf_counter_s: float) -> float:
        """An absolute ``time.perf_counter()`` stamp in trace time."""
        return (perf_counter_s - self.t0) * 1e6

    def _emit(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            self.events.append(ev)

    def complete(self, name: str, start_us: float, dur_us: float, *,
                 cat: str = "span", args: Optional[dict] = None) -> None:
        """Record a complete ("X") event: the span [start, start + dur)."""
        self._emit({
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": round(start_us, 3),
            "dur": round(max(dur_us, 0.0), 3),
            "pid": self.pid,
            "tid": threading.get_ident(),
            "args": dict(args or {}),
        })

    def instant(self, name: str, *, cat: str = "instant", **args) -> None:
        self._emit({
            "name": name,
            "cat": cat,
            "ph": "i",
            "s": "t",
            "ts": round(self.now_us(), 3),
            "pid": self.pid,
            "tid": threading.get_ident(),
            "args": args,
        })

    def span(self, name: str, *, cat: str = "span", **args) -> _Span:
        return _Span(self, name, cat, args)

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            events = list(self.events)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"producer": "repro_torch.observability.trace"},
        }

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            # default=str: span args may carry dtypes, devices, shapes
            json.dump(self.to_json(), f, default=str)
            f.write("\n")
        return path


# =============================================================================
# module-level switchboard
# =============================================================================


def get_tracer() -> Optional[Any]:
    """The installed tracer, or None."""
    return _TRACER


def set_tracer(tracer: Optional[Any]) -> None:
    """Install ``tracer`` and turn dispatch tracing on; None turns it off and
    drops the tracer and its export path."""
    global TRACING, _TRACER, _EXPORT_PATH
    with _LOCK:
        _TRACER = tracer
        TRACING = tracer is not None
        if tracer is None:
            _EXPORT_PATH = None


def enable(path: Optional[str] = None) -> Tracer:
    """Turn tracing on (idempotent); ``path`` is where :func:`export` and the
    exit hook write."""
    global TRACING, _TRACER, _EXPORT_PATH, _ATEXIT_REGISTERED
    with _LOCK:
        if _TRACER is None:
            _TRACER = Tracer()
        if path is not None:
            _EXPORT_PATH = path
            if not _ATEXIT_REGISTERED:
                atexit.register(_export_at_exit)
                _ATEXIT_REGISTERED = True
        TRACING = True
        return _TRACER


def disable() -> None:
    """Stop recording; the tracer keeps its events for :func:`export`."""
    global TRACING
    TRACING = False


def enabled() -> bool:
    return TRACING


def reset() -> None:
    """Drop the tracer, its events and its export path."""
    set_tracer(None)


def span(name: str, *, cat: str = "span", **args):
    """A span context manager; the shared no-op one while tracing is off."""
    if not TRACING or _TRACER is None:
        return _NULL_SPAN
    return _Span(_TRACER, name, cat, args)


def instant(name: str, *, cat: str = "instant", **args) -> None:
    """An instant event on the installed tracer, while tracing is on."""
    if TRACING and _TRACER is not None:
        emit = getattr(_TRACER, "instant", None)
        if emit is not None:
            emit(name, cat=cat, **args)


def export(path: Optional[str] = None) -> Optional[str]:
    """Write the installed :class:`Tracer`'s events to ``path`` (default: the
    path given to :func:`enable`); None when there is nothing to write."""
    target = path or _EXPORT_PATH
    if not isinstance(_TRACER, Tracer) or target is None:
        return None
    return _TRACER.export(target)


def _export_at_exit() -> None:
    try:
        export()
    except OSError:
        pass  # an unwritable path must not break interpreter teardown


class _TracingContext:
    def __init__(self, path: Optional[str]):
        self.path = path

    def __enter__(self) -> Tracer:
        return enable(self.path)

    def __exit__(self, *exc):
        if self.path is not None:
            export(self.path)
        disable()
        return False


def tracing(path: Optional[str] = None) -> _TracingContext:
    """``with tracing("out.json"):`` — enable, run, export, disable."""
    return _TracingContext(path)


# =============================================================================
# validation
# =============================================================================


def validate_trace(data) -> List[str]:
    """Problems of a Chrome trace-event object (or a path to one); empty
    means valid: ``name``/``ph``/``ts`` on every event, ``dur >= 0`` on
    complete events, integer ``pid``/``tid``, object ``args``."""
    errors: List[str] = []
    if isinstance(data, (str, os.PathLike)):
        try:
            with open(data) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            return [f"unreadable trace file: {e}"]
    if not isinstance(data, dict):
        return [f"top level must be an object, got {type(data).__name__}"]
    events = data.get("traceEvents")
    if not isinstance(events, list):
        return ["missing 'traceEvents' list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        name = ev.get("name")
        if not isinstance(name, str) or not name:
            errors.append(f"{where}: missing/empty 'name'")
        ph = ev.get("ph")
        if ph not in _VALID_PHASES:
            errors.append(f"{where}: bad phase {ph!r}")
        if not isinstance(ev.get("ts"), (int, float)):
            errors.append(f"{where}: missing numeric 'ts'")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: complete event needs 'dur' >= 0")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                errors.append(f"{where}: missing integer {key!r}")
        if "args" in ev and not isinstance(ev["args"], dict):
            errors.append(f"{where}: 'args' must be an object")
        if len(errors) > 50:
            errors.append("... (truncated)")
            break
    return errors


# =============================================================================
# entry points
# =============================================================================


def add_cli_flag(parser) -> None:
    """Attach the ``--trace OUT_JSON`` flag to an entry point's parser."""
    parser.add_argument(
        "--trace", metavar="OUT_JSON", default=None,
        help="write a Chrome trace-event file of this run's dispatches and spans")


def enable_from_args(args) -> Optional[str]:
    """Turn tracing on when ``--trace`` was given; returns its path."""
    path = getattr(args, "trace", None)
    if path:
        enable(path)
        return path
    return None


def maybe_enable_from_env() -> bool:
    """Honour ``REPRO_TRACE=1`` (export to ``REPRO_TRACE_PATH`` at exit)."""
    flag = os.environ.get(ENV_FLAG, "").strip().lower()
    if flag in ("1", "true", "yes", "on"):
        enable(os.environ.get(ENV_PATH, DEFAULT_PATH))
        return True
    return False


maybe_enable_from_env()
