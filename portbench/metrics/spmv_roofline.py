"""``spmv_roofline`` (%): the least time of the traced slice's operator applies
(``counting.spmv_bytes`` / ``spmv_flops``: y = A x, and the fused dot where
there is one; one apply an iteration and one for the initial residual) over
the device time of the kernels that implement them, matched by name."""

from portbench import counting, profiling

#: kernels that apply A (ELL, the fused ELL SpMV + dot, SELL-P)
PATTERNS = (r"spmv_ell", r"spmv_dot_ell", r"spmv_sellp")


def read(ctx):
    tr, kind = ctx["trace"], ctx["device_kind"]
    if tr is None or kind is None:
        return None
    t = profiling.kernel_seconds(tr, PATTERNS)
    if t <= 0:
        return None
    p = ctx["problem"]
    applies = tr["iterations"] + tr["solves"]
    least = applies * counting.least_seconds(
        counting.spmv_bytes(p), counting.spmv_flops(p), p["dtype"], kind)
    return 100.0 * least / t
