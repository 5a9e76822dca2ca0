"""``precond_apply_whole_roofline`` (%): the least time of the traced slice's
preconditioner applies (the numerator of ``precond_apply_roofline``:
``counting.precond_bytes`` / ``precond_flops``, one apply an iteration and
one for the initial residual) over the device seconds of the program's
``precond.apply`` spans, from ``trace.device_span_totals()``.

Each span is timed by a pair of events on the stream at its enter and exit,
so the denominator holds the whole apply: the pad-and-gather, the
class-slice kernels, the concatenation and the scatter, and any time the
device waits on the host between them inside the span.  It does not hold
the apply's host time before the stream reaches the first event.

Nothing off the card, where the program has no device-timed spans (a
program without them, or one whose spans were not timed), or where the
span count is not the slice's iterations plus solves (spans recorded
outside the slice, as when the program's own tracing is on)."""

from portbench import counting


def _apply_totals():
    try:
        from repro_torch.observability import trace
    except ImportError:
        return None
    totals = getattr(trace, "device_span_totals", None)
    return totals().get("precond.apply") if totals is not None else None


def read(ctx):
    tr, kind = ctx["trace"], ctx["device_kind"]
    if tr is None or kind is None:
        return None
    spans = _apply_totals()
    applies = tr["iterations"] + tr["solves"]
    if not spans or spans["count"] != applies or spans["device_s"] <= 0:
        return None
    p = ctx["problem"]
    least = applies * counting.least_seconds(
        counting.precond_bytes(p), counting.precond_flops(p), p["dtype"], kind)
    return 100.0 * least / spans["device_s"]
