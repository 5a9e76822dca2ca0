"""``precond_setup_s``: host clock around ``make_preconditioner`` (block
discovery, extraction and precision selection on the host, inversion on the
device), synchronised at both ends."""


def read(ctx):
    return ctx["spans"].get("precond")
