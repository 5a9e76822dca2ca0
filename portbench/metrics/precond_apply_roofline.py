"""``precond_apply_roofline`` (%): the least time of the traced slice's
preconditioner applies (``counting.precond_bytes`` / ``precond_flops``:
z = M^-1 r from the stored inverses; one apply an iteration and one for the
initial residual) over the device time of the kernels that apply the block
inverses, matched by name.

It reads the block-inverse kernel alone.  The apply also runs generic
PyTorch passes around that kernel (the index gathers and scatters, the
padding and class concatenations); their names say nothing of the apply,
so no pattern here can claim them, and they stay out of the denominator.
So this share does not move when those passes go, and a change that moves
work out of the kernel into generic passes reads better here: the whole
apply's time is for spans on the preconditioner, which the program lacks,
and ``solve_mfu`` bounds both cases."""

from portbench import counting, profiling

#: kernels of z = M^-1 r on the block-Jacobi path
PATTERNS = (r"block_jacobi",)


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
        counting.precond_bytes(p), counting.precond_flops(p), p["dtype"], kind)
    return 100.0 * least / t
