"""``amg_coarse_share`` (ratio): the share of the multigrid preconditioner's
apply spent below the finest level — the device seconds of the program's
``amg.coarse`` spans (from the restricted residual to the coarse
correction, once an apply) over those of its ``precond.apply`` spans, both
from ``trace.device_span_totals()``.

The coarse levels hold a small share of the bytes; a large share of the
time there is latency and dispatch, the finding a captured or fused coarse
cycle starts from.

Nothing off the card, where the program has no device-timed spans (a
program without them, or one whose spans were not timed), where either
span is missing, or where the two span counts differ from each other or
from the slice's applies, its iterations plus its solves (an apply without
its coarse span, or spans recorded outside the slice)."""


def _totals():
    try:
        from repro_torch.observability import trace
    except ImportError:
        return {}
    totals = getattr(trace, "device_span_totals", None)
    return totals() if totals is not None else {}


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx["device_kind"] is None:
        return None
    t = _totals()
    coarse, apply = t.get("amg.coarse"), t.get("precond.apply")
    applies = tr["iterations"] + tr["solves"]
    if (not coarse or not apply or coarse["count"] != applies
            or apply["count"] != applies or apply["device_s"] <= 0):
        return None
    return coarse["device_s"] / apply["device_s"]
