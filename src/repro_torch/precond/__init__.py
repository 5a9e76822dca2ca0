"""repro_torch.precond — block-Jacobi, smoothed-aggregation AMG, and the
string-keyed factory the solvers use to resolve ``M="block_jacobi"``-style
arguments."""

from __future__ import annotations

from repro_torch.precond.block_jacobi import (
    ADAPTIVE_TAU,
    BatchBlockJacobi,
    BatchBlockJacobiPattern,
    BlockJacobi,
    batch_block_jacobi,
    batch_block_jacobi_blocks,
    batch_block_jacobi_factors,
    batch_block_jacobi_from_factors,
    batch_block_jacobi_pattern,
    block_jacobi,
    extract_blocks,
    invert_blocks,
    natural_blocks,
    select_block_precisions,
    uniform_block_ptrs,
    unit_roundoff,
)

__all__ = [
    "ADAPTIVE_TAU",
    "BatchBlockJacobi",
    "BatchBlockJacobiPattern",
    "BlockJacobi",
    "batch_block_jacobi",
    "batch_block_jacobi_blocks",
    "batch_block_jacobi_factors",
    "batch_block_jacobi_from_factors",
    "batch_block_jacobi_pattern",
    "block_jacobi",
    "extract_blocks",
    "invert_blocks",
    "natural_blocks",
    "select_block_precisions",
    "uniform_block_ptrs",
    "unit_roundoff",
    "make_preconditioner",
    "Multigrid",
    "amg_preconditioner",
]

from repro_torch.precond.amg import Multigrid, amg_preconditioner  # noqa: E402


def make_preconditioner(A, kind: str, *, executor=None, **opts):
    """Resolve a preconditioner by name — the solvers' ``M=<str>`` path.

    Kinds: ``identity``, ``jacobi`` (scalar; accepts ``adaptive``),
    ``block_jacobi`` (accepts ``block_size``/``blocks``/``adaptive``/``tau``),
    ``amg`` (aggregation multigrid on a CSR or ELL ``A``, smoothed unless
    ``smooth_prolongator=False``; accepts
    ``theta``/``cycle``/``smoother``/``coarse_solver``/... — see
    :class:`repro_torch.precond.amg.Multigrid`), ``parilu`` (on a CSR ``A``;
    accepts ``factor_sweeps``/``solve_sweeps``/``structure`` — see
    :func:`repro_torch.solvers.parilu.parilu_preconditioner`).
    """
    if kind == "identity":
        if opts:
            raise ValueError(
                f"identity preconditioner takes no options, got {sorted(opts)}"
            )
        from repro_torch.solvers.common import identity_preconditioner

        return identity_preconditioner
    if kind == "jacobi":
        from repro_torch.solvers.common import jacobi_preconditioner

        return jacobi_preconditioner(A, executor=executor, **opts)
    if kind == "block_jacobi":
        return block_jacobi(A, executor=executor, **opts)
    if kind == "amg":
        return amg_preconditioner(A, executor=executor, **opts)
    if kind == "parilu":
        from repro_torch.solvers.parilu import parilu_preconditioner

        return parilu_preconditioner(A, **opts)
    raise KeyError(
        f"unknown preconditioner kind {kind!r}; known: "
        "identity, jacobi, block_jacobi, parilu, amg"
    )
