"""Dispatch telemetry — the record behind ``Executor.dispatch_log``.

:class:`DispatchLog` is a ``Counter`` of operation names (the face the
launch-count pins read) plus a bounded deque of :class:`DispatchEvent`
records that fills only while :data:`repro_torch.observability.trace.TRACING`
is on.  Each event holds what Ginkgo's operation logger sees at a launch:

* the operation, the **kernel space** that served it (``reference`` /
  ``torch`` / ``cuda``), the executor and its hardware **target**;
* the operand **shapes** and their power-of-two **shape bucket** (the
  bucketing of :func:`repro_torch.core.tuning.bucket_shapes`);
* the :class:`~repro_torch.core.tuning.LaunchConfig` the kernel resolved,
  where it resolved one;
* the **host time** of the dispatch: the call's time on the host, which
  on a card is the launch and not the kernel (no dispatch synchronises;
  device time is the profiler's).

Stdlib only: the registry imports it at module load.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "EVENT_CAPACITY",
    "DispatchEvent",
    "DispatchLog",
    "make_event",
    "shape_bucket",
    "summarize_operands",
]

#: bounded so a long traced run cannot grow without limit
EVENT_CAPACITY = 4096


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def shape_bucket(shapes) -> int:
    """Power-of-two bucket of the largest operand's element count."""
    biggest = 0
    for shp in shapes:
        size = 1
        for d in shp:
            size *= int(d)
        biggest = max(biggest, size)
    return _next_pow2(biggest)


def summarize_operands(objs) -> Tuple[List[tuple], int]:
    """``(shapes, estimated_bytes)`` of a bag of operands.

    A format object with ``memory_bytes`` (``Csr``, ``Ell``, ``Sellp``,
    ``Coo``, ``Dense``, ``BatchCsr``, ``BatchEll``) counts those bytes; a
    tensor or array counts its elements times ``dtype.itemsize``; tuples,
    lists and dicts are walked.  Scalars and other objects count nothing.
    """
    shapes: List[tuple] = []
    nbytes = 0
    stack = list(objs)
    budget = 256  # bound on pathological nesting
    while stack and budget:
        budget -= 1
        o = stack.pop()
        if o is None or isinstance(o, (bool, int, float, complex, str, bytes)):
            continue
        shp = getattr(o, "shape", None)
        if shp is not None:
            try:
                shp = tuple(int(d) for d in shp)
            except (TypeError, ValueError):
                continue
            shapes.append(shp)
            mb = getattr(o, "memory_bytes", None)
            if mb is not None:
                nbytes += int(mb)
                continue
            itemsize = int(getattr(getattr(o, "dtype", None), "itemsize", 0) or 4)
            size = 1
            for d in shp:
                size *= d
            nbytes += size * itemsize
        elif isinstance(o, (tuple, list)):
            stack.extend(o)
        elif isinstance(o, dict):
            stack.extend(o.values())
    return shapes, nbytes


@dataclasses.dataclass(frozen=True)
class DispatchEvent:
    """One operation dispatch, fully described."""

    op: str
    space: str
    executor: str
    target: str
    shapes: Tuple[tuple, ...]
    shape_bucket: int
    launch: Optional[Dict[str, Any]]
    host_us: float
    ts_us: float

    def to_args(self) -> Dict[str, Any]:
        """The ``args`` payload of the trace event for this dispatch."""
        args: Dict[str, Any] = {
            "space": self.space,
            "executor": self.executor,
            "target": self.target,
            "shapes": [list(s) for s in self.shapes],
            "shape_bucket": self.shape_bucket,
        }
        if self.launch is not None:
            args["launch"] = self.launch
        return args


def make_event(*, op: str, space: str, executor, launch, host_us: float,
               ts_us: float, operands) -> DispatchEvent:
    """A :class:`DispatchEvent` for a finished dispatch."""
    in_shapes, _ = summarize_operands(operands)
    launch_dict = None
    if launch is not None and dataclasses.is_dataclass(launch):
        launch_dict = dataclasses.asdict(launch)
    return DispatchEvent(
        op=op,
        space=space,
        executor=type(executor).__name__,
        target=executor.hw.name,
        host_us=host_us,
        ts_us=ts_us,
        shapes=tuple(in_shapes),
        shape_bucket=shape_bucket(in_shapes),
        launch=launch_dict,
    )


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
