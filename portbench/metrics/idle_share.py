"""``idle_share``: 1 - (union of the device's operation intervals) / (the
traced slice's length), from the profiler's trace.  Nothing on a run with
no device activity in the trace."""

from portbench import profiling


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["device"] or ctx["device_kind"] is None:
        return None
    return 1.0 - profiling.busy_seconds(tr) / tr["window_s"]
