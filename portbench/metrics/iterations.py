"""``iterations``: mean ``SolveResult.iterations`` over the window's solves
(the solver loop's own count)."""


def read(ctx):
    it = ctx["window"]["iterations"]
    return sum(it) / len(it)
