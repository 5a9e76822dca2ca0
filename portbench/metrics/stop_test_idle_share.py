"""``stop_test_idle_share``: the device's idle time in the traced slice that
begins inside the program's ``cg.stop_test`` host ranges (the CG loop's
blocking read of the residual norm), over the slice's length.

The gaps are those of ``idle_share``: the union of the slice's device
operations, its gaps each from the end of one operation to the start of
the next (or to the slice's end).  Host ranges and device operations are
both the profiler's events, on its clock.  A gap counts whole when it
begins inside a stop test: the device ran dry while the host waited on the
norm, and it stays idle until the host has launched the next iteration's
first operation.  A gap that begins before the stop test does not count,
though the host may reach the test within it.

Nothing off the card, with no device activity in the trace, or with no
``cg.stop_test`` range in the slice (a program without the spans)."""

import bisect

from portbench import profiling

SPAN = "cg.stop_test"


def gaps(tr):
    """The slice's device-idle intervals, ``[(start_ns, end_ns), ...]``."""
    lo, hi = tr["lo_ns"], tr["hi_ns"]
    busy = profiling._union([(max(s, lo), min(e, hi)) for _, s, e in tr["device"]])
    out, prev = [], lo
    for s, e in busy:
        if s > prev:
            out.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        out.append((prev, hi))
    return out


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["device"] or ctx["device_kind"] is None:
        return None
    lo, hi = tr["lo_ns"], tr["hi_ns"]
    tests = sorted((s, e) for n, s, e in tr["host"] if n == SPAN and e > lo and s < hi)
    if not tests:
        return None
    starts = [s for s, _ in tests]
    idle = 0
    for g0, g1 in gaps(tr):
        k = bisect.bisect_right(starts, g0) - 1
        if k >= 0 and tests[k][1] >= g0:
            idle += g1 - g0
    return idle * 1e-9 / tr["window_s"]
