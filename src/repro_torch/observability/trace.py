"""Span tracer with Chrome trace-event export — the ``gko::log`` analogue.

One :func:`span` feeds two sinks on one clock:

* the port's :class:`Tracer`, while :data:`TRACING` is on: a complete
  ("X") event per span, written as a Chrome trace-event file
  (``{"traceEvents": [...]}``, viewable in Perfetto) that
  :func:`validate_trace` checks;
* a running ``torch.profiler``: a host-only range of the span's name
  (``RecordFunctionFast``, FUNCTION scope), which the profiler records on
  its own clock and does not mirror on the device timeline.

Both stamp the profiler's clock, Unix-epoch nanoseconds
(``time.time_ns``): a :class:`Tracer` file's ``ts`` plus its
``otherData.t0_ns`` lies on the same axis as a profiler trace's events.

While both are off, :func:`span` returns a shared no-op context manager
after two flag reads (no allocation, no clock read), and the dispatch layer
pays one flag read more per operation for its ``op.<name>`` ranges
(:func:`host_range`).  While :data:`TRACING` is on the registry also
records a :class:`~repro_torch.observability.events.DispatchEvent` per
dispatch and hands the installed tracer one complete event for it, timed on
the host: no dispatch synchronises the device.  A tracer is any object with
``rel_us(t_ns) -> float`` (``t_ns`` a :func:`now_ns` stamp) and
``complete(name, ts_us, dur_us, cat=..., args=...)`` (``instant`` is
optional); :class:`Tracer` is the one this module installs.

A span given ``device_of=`` a CUDA tensor is also timed on the device
while it records: a pooled pair of timing events on the tensor's current
stream at enter and exit, never synchronised on the way.  Completed pairs
fold into per-name totals (count, device seconds), which
:func:`device_span_totals` returns and :func:`reset_device_spans` clears.

Activation: ``REPRO_TRACE=1`` in the environment enables tracing at import
and exports to ``REPRO_TRACE_PATH`` (default ``repro_trace.json``) at exit;
an entry point's ``--trace OUT_JSON`` flag (:func:`add_cli_flag`,
:func:`enable_from_args`, then :func:`export`); ``with tracing(path):``; or
:func:`enable` / :func:`export` / :func:`disable`.  The profiler sink needs
no switch: it records while a profiler runs.
"""

from __future__ import annotations

import atexit
import collections
import itertools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler  # its _is_profiler_enabled

try:
    from torch._C._profiler import _RecordFunctionFast as _HostRange
except ImportError:  # a torch without it: the profiler sink stays empty
    _HostRange = None

__all__ = [
    "TRACING",
    "Tracer",
    "ENV_FLAG",
    "ENV_PATH",
    "add_cli_flag",
    "device_span_totals",
    "disable",
    "enable",
    "enable_from_args",
    "enabled",
    "export",
    "get_tracer",
    "host_range",
    "instant",
    "maybe_enable_from_env",
    "next_solve_index",
    "now_ns",
    "reset",
    "reset_device_spans",
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

#: the clock of every stamp: torch.profiler's, Unix-epoch nanoseconds
now_ns: Callable[[], int] = time.time_ns

#: this process's solves, in order: the ``solve`` span's index
next_solve_index: Callable[[], int] = itertools.count().__next__


class _NullSpan:
    """The shared no-op span returned while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _DeviceSpans:
    """Device time of spans by name, from pooled timing-event pairs.

    :meth:`open` records a pair's first event on the tensor's current
    stream, :meth:`close` the second on the same stream; neither waits on
    the device.  Once ``FOLD_AT`` pairs wait, a close folds the completed
    ones into their names' totals and returns them to the pool; reading
    the totals folds every pair.  Past ``MAX_PENDING`` waiting pairs a
    close waits for the oldest ones."""

    FOLD_AT = 32
    MAX_PENDING = 1024

    def __init__(self, event: Optional[Callable[[], Any]] = None,
                 stream: Optional[Callable[[Any], Any]] = None):
        self._event = event or (lambda: torch.cuda.Event(enable_timing=True))
        self._stream = stream or torch.cuda.current_stream
        self._free: Dict[Any, list] = {}
        self._pending: collections.deque = collections.deque()
        self._totals: Dict[str, list] = {}
        self._lock = threading.Lock()

    def open(self, tensor):
        dev = tensor.device
        with self._lock:
            free = self._free.get(dev)
            pair = free.pop() if free else (self._event(), self._event())
        stream = self._stream(dev)
        pair[0].record(stream)
        return dev, stream, pair

    def close(self, name: str, opened) -> None:
        dev, stream, pair = opened
        pair[1].record(stream)
        with self._lock:
            self._pending.append((name, dev, pair))
            if len(self._pending) >= self.FOLD_AT:
                self._fold()

    def _fold(self) -> None:
        while self._pending:
            name, dev, (a, b) = self._pending[0]
            if len(self._pending) > self.MAX_PENDING:
                b.synchronize()
            elif not b.query():
                return
            self._pending.popleft()
            tot = self._totals.setdefault(name, [0, 0.0])
            tot[0] += 1
            tot[1] += a.elapsed_time(b) * 1e-3
            self._free.setdefault(dev, []).append((a, b))

    def _drain(self) -> None:
        for _, _, (_, b) in self._pending:
            b.synchronize()
        self._fold()

    def totals(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            self._drain()
            return {name: {"count": c, "device_s": s}
                    for name, (c, s) in self._totals.items()}

    def reset(self) -> None:
        with self._lock:
            self._drain()
            self._totals.clear()


_DEVICE = _DeviceSpans()


def device_span_totals() -> Dict[str, Dict[str, float]]:
    """``{name: {"count": n, "device_s": seconds}}`` of the device-timed
    spans closed since the last :func:`reset_device_spans`, waiting for
    the pairs still in flight."""
    return _DEVICE.totals()


def reset_device_spans() -> None:
    """Drop the device-timed spans' totals (the pairs in flight too)."""
    _DEVICE.reset()


class _Span:
    """An open span: a complete event for the tracer, a host range for a
    running profiler and a device-timed pair, each where there is one."""

    __slots__ = ("tracer", "name", "cat", "args", "t0", "host", "device_of",
                 "opened")

    def __init__(self, tracer, name: str, cat: str, args: dict,
                 host=None, device_of=None):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.host = host
        self.device_of = device_of
        self.t0 = 0
        self.opened = None

    def __enter__(self):
        if self.host is not None:
            self.host.__enter__()
        if self.device_of is not None:
            self.opened = _DEVICE.open(self.device_of)
        if self.tracer is not None:
            self.t0 = now_ns()
        return self

    def __exit__(self, *exc):
        if self.tracer is not None:
            t1 = now_ns()
            self.tracer.complete(self.name, self.tracer.rel_us(self.t0),
                                 (t1 - self.t0) * 1e-3, cat=self.cat,
                                 args=self.args)
        if self.opened is not None:
            _DEVICE.close(self.name, self.opened)
        if self.host is not None:
            self.host.__exit__(*exc)
        return False


class Tracer:
    """Accumulates trace events, timestamps relative to its creation on the
    profiler's clock (``otherData.t0_ns`` in the exported file)."""

    def __init__(self):
        self.events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self.t0_ns = now_ns()
        self.pid = os.getpid()

    def now_us(self) -> float:
        return (now_ns() - self.t0_ns) * 1e-3

    def rel_us(self, t_ns: int) -> float:
        """An absolute :func:`now_ns` stamp in trace time."""
        return (t_ns - self.t0_ns) * 1e-3

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
            "otherData": {"producer": "repro_torch.observability.trace",
                          "clock": "unix_epoch_ns", "t0_ns": self.t0_ns},
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


def span(name: str, *, cat: str = "span", device_of=None, **args):
    """A span context manager: to the :class:`Tracer` while :data:`TRACING`
    is on, a host range while a ``torch.profiler`` runs, and device-timed
    while either records and ``device_of`` is a CUDA tensor.  The shared
    no-op span while both are off."""
    profiling = _profiler._is_profiler_enabled
    if not TRACING and not profiling:
        return _NULL_SPAN
    return _Span(_TRACER if TRACING else None, name, cat, args,
                 _HostRange(name) if profiling and _HostRange else None,
                 device_of if device_of is not None and device_of.is_cuda
                 else None)


def host_range(name: str):
    """A host-only profiler range of ``name`` (FUNCTION scope, not mirrored
    on the device timeline); the shared no-op span where this torch lacks
    one.  For a caller that has read the profiler's flag itself."""
    return _HostRange(name) if _HostRange is not None else _NULL_SPAN


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
