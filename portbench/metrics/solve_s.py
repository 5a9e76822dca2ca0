"""``solve_s``: time to solution — the window's wall time (host clock, from
the first solve's call to the synchronised return of the last) over the
solves completed."""


def read(ctx):
    w = ctx["window"]
    return w["seconds"] / w["solves"]
