"""``dispatch_host_us`` (us): the mean host duration of the program's
``op.<operation>`` ranges in the traced slice, one a dispatch through the
operation registry: resolving the kernel space, the implementation's
Python and the launches it makes.

The profiler records each ATen call inside a range as well, which adds its
own cost, so an untraced dispatch takes somewhat less.  Work outside the
registry (the solver loop's own tensor arithmetic, the spans) is not in it.
Nothing off the card or with no such range in the slice (a program without
them)."""

PREFIX = "op."


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx["device_kind"] is None:
        return None
    lo, hi = tr["lo_ns"], tr["hi_ns"]
    d = [e - s for n, s, e in tr["host"] if n.startswith(PREFIX) and s >= lo and e <= hi]
    if not d:
        return None
    return sum(d) / len(d) * 1e-3
