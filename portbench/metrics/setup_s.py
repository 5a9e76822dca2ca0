"""``setup_s``: from the harness's first statement to the first timed solve
(imports, the CUDA context, loading the built library, the inputs, the
format, the preconditioner, the solver's generation and the warm-up solve);
host clock."""


def read(ctx):
    return ctx["setup_s"]
