"""Dispatch telemetry — the record behind ``Executor.dispatch_log``.

:class:`DispatchLog` is a ``Counter`` of operation names (the face the
launch-count pins read) plus a bounded deque of :class:`DispatchEvent`
records that fills only while :data:`repro_torch.observability.trace.TRACING`
is on.  Stdlib only.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

__all__ = ["EVENT_CAPACITY", "DispatchEvent", "DispatchLog"]

#: bounded so a long traced run cannot grow without limit
EVENT_CAPACITY = 4096


@dataclasses.dataclass(frozen=True)
class DispatchEvent:
    """One operation dispatch: which op, which kernel space served it, where."""

    op: str
    space: str
    executor: str
    target: str
    wall_us: float
    ts_us: float

    def to_args(self) -> dict:
        """The ``args`` payload of a trace event for this dispatch."""
        return {
            "space": self.space,
            "executor": self.executor,
            "target": self.target,
        }


class DispatchLog(collections.Counter):
    """``Counter`` of op names + bounded deque of structured events."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.events: collections.deque = collections.deque(maxlen=EVENT_CAPACITY)

    def record(self, op_name: str, event: Optional[DispatchEvent] = None) -> None:
        self[op_name] += 1
        if event is not None:
            self.events.append(event)

    def clear(self) -> None:  # counts and events clear as one unit
        super().clear()
        self.events.clear()
