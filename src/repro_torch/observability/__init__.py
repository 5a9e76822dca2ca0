"""Observability: tracing, dispatch events, metrics, convergence telemetry.

The port's ``gko::log`` layer, four pieces usable alone:

* :mod:`repro_torch.observability.trace` — spans to a tracer with Chrome
  trace-event export (``REPRO_TRACE=1`` or ``--trace out.json`` on the
  entry points) and to a running ``torch.profiler``, on its clock, some
  timed on the device;
* :mod:`repro_torch.observability.events` — structured dispatch events
  behind ``Executor.dispatch_log``;
* :mod:`repro_torch.observability.metrics` — counters, gauges and
  histograms with JSONL and table exporters;
* :mod:`repro_torch.observability.convergence` — the residual-history ring
  buffer behind every solver's ``history=`` option.

The dispatch layer imports ``trace``, ``events`` and ``metrics``
unconditionally (``events`` and ``metrics`` are stdlib only, ``trace``
binds torch's profiler module); ``convergence`` is imported lazily here.
"""

from repro_torch.observability import events, metrics, trace
from repro_torch.observability.events import DispatchEvent, DispatchLog
from repro_torch.observability.trace import span, validate_trace

__all__ = [
    "events",
    "metrics",
    "trace",
    "convergence",
    "DispatchEvent",
    "DispatchLog",
    "span",
    "validate_trace",
]


def __getattr__(name):
    if name == "convergence":
        import importlib

        return importlib.import_module("repro_torch.observability.convergence")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
