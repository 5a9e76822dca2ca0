"""``launches_per_iter``: kernels that ran on the device in the traced
slice (copies and fills left out) over the slice's CG iterations."""

from portbench import profiling


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["device"] or not tr["iterations"]:
        return None
    return profiling.kernel_launches(tr) / tr["iterations"]
