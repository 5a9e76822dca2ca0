"""repro_torch.solvers — CG (unfused and fused) and the shared solver machinery."""

from repro_torch.solvers.common import (
    ScalarJacobi,
    SolveResult,
    Stop,
    ensure_symmetric,
    identity_preconditioner,
    jacobi_preconditioner,
    probe_symmetry,
)
from repro_torch.solvers.krylov import CgSolver, cg

__all__ = [
    "CgSolver",
    "ScalarJacobi",
    "SolveResult",
    "Stop",
    "cg",
    "ensure_symmetric",
    "identity_preconditioner",
    "jacobi_preconditioner",
    "probe_symmetry",
]
