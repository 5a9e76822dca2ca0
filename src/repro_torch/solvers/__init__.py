"""repro_torch.solvers — Krylov solvers (Ginkgo's solver set), ParILU and
iterative refinement, executor-agnostic.

Every solver function has a factory-style LinOp twin (``CgSolver`` etc.), so
a generated solver composes as an operator, and :mod:`repro_torch.solvers.ir`
builds mixed-precision iterative refinement on that interface.
"""

from repro_torch.solvers.common import (
    LinearOperator,
    ScalarJacobi,
    SolveResult,
    Stop,
    block_jacobi_preconditioner,
    ensure_symmetric,
    identity_preconditioner,
    jacobi_preconditioner,
    probe_symmetry,
)
from repro_torch.solvers.krylov import (
    BicgstabSolver,
    CgSolver,
    CgsSolver,
    FcgSolver,
    GmresSolver,
    KrylovSolver,
    PipelinedCgSolver,
    bicgstab,
    cg,
    cgs,
    fcg,
    gmres,
)
from repro_torch.solvers.ir import IrSolver, ir, mixed_precision_ir
from repro_torch.solvers.parilu import (
    ParILU,
    parilu_factorize,
    parilu_preconditioner,
    parilu_setup,
)

__all__ = [
    "LinearOperator",
    "ScalarJacobi",
    "SolveResult",
    "Stop",
    "ensure_symmetric",
    "identity_preconditioner",
    "jacobi_preconditioner",
    "block_jacobi_preconditioner",
    "probe_symmetry",
    "cg",
    "fcg",
    "bicgstab",
    "cgs",
    "gmres",
    "ir",
    "mixed_precision_ir",
    "KrylovSolver",
    "CgSolver",
    "FcgSolver",
    "BicgstabSolver",
    "CgsSolver",
    "GmresSolver",
    "PipelinedCgSolver",
    "IrSolver",
    "ParILU",
    "parilu_factorize",
    "parilu_preconditioner",
    "parilu_setup",
]
