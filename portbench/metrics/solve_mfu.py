"""``solve_mfu`` (%): the whole solve's share of the card's peak — the least
time of the window's solves (``counting.solve_bytes`` at the HBM rate or
``counting.solve_flops`` at the dtype's rate, whichever is larger; over the
mean iterations) over their measured time (``solve_s``).  Bound by HBM
bandwidth here, so it is a roofline share named as the repo names a whole
step's share of the peak."""

from portbench import counting


def read(ctx):
    kind = ctx["device_kind"]
    if kind is None:
        return None
    w, p = ctx["window"], ctx["problem"]
    its = sum(w["iterations"])
    least = counting.least_seconds(counting.solve_bytes(p, its, w["solves"]),
                                   counting.solve_flops(p, its), p["dtype"], kind)
    return 100.0 * least / w["seconds"]
