"""repro_torch.batch — batched linear algebra (gko::batch::*).

Thousands of small independent sparse systems solved together: batched
formats with a shared sparsity pattern (:mod:`repro_torch.batch.formats`),
executor-dispatched batched SpMV and BLAS-1 (:mod:`repro_torch.batch.ops`),
and masked batched Krylov solvers whose per-system convergence mask freezes
finished systems (:mod:`repro_torch.batch.solvers`).  The entry point is
:mod:`repro_torch.launch.batch_solve`.
"""

from repro_torch.batch.linop import (
    BatchComposition,
    BatchIdentity,
    BatchLinOp,
    BatchMatrixFreeOp,
    BatchScaledIdentity,
    BatchSum,
)
from repro_torch.batch.formats import (
    BatchCsr,
    BatchEll,
    batch_csr_from_dense,
    batch_csr_from_list,
    batch_ell_from_batch_csr,
    batch_ell_from_dense,
    batch_ell_from_list,
)
from repro_torch.batch.ops import (
    apply_batch,
    batch_axpy,
    batch_axpy_norm,
    batch_dot,
    batch_norm2,
    batch_scal,
)
from repro_torch.batch.solvers import (
    BatchBicgstabState,
    BatchCgState,
    BatchScalarJacobi,
    BatchSolveResult,
    batch_bicgstab,
    batch_bicgstab_advance,
    batch_bicgstab_init,
    batch_block_jacobi_preconditioner,
    batch_cg,
    batch_cg_advance,
    batch_cg_init,
    batch_identity_preconditioner,
    batch_jacobi_preconditioner,
)

__all__ = [
    "BatchLinOp",
    "BatchComposition",
    "BatchSum",
    "BatchScaledIdentity",
    "BatchMatrixFreeOp",
    "BatchIdentity",
    "BatchCsr",
    "BatchEll",
    "batch_csr_from_list",
    "batch_ell_from_list",
    "batch_csr_from_dense",
    "batch_ell_from_dense",
    "batch_ell_from_batch_csr",
    "apply_batch",
    "batch_dot",
    "batch_axpy",
    "batch_axpy_norm",
    "batch_scal",
    "batch_norm2",
    "BatchSolveResult",
    "BatchCgState",
    "BatchBicgstabState",
    "BatchScalarJacobi",
    "batch_cg",
    "batch_cg_init",
    "batch_cg_advance",
    "batch_bicgstab",
    "batch_bicgstab_init",
    "batch_bicgstab_advance",
    "batch_jacobi_preconditioner",
    "batch_block_jacobi_preconditioner",
    "batch_identity_preconditioner",
]
