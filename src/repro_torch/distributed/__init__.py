"""repro_torch.distributed — row-partitioned operators, vectors and solves
over ``torch.distributed``.

The gko::experimental::distributed analogue (arXiv:2006.16852), one process
a part: a :class:`Partition` of the row space, row-partitioned formats
(:class:`DistCsr` / :class:`DistEll`) whose SpMV is the local-block SpMV
plus a halo all-gather, padded distributed vectors (:class:`DistVector`)
whose reductions sum over the ranks in a fixed order, rank-local
preconditioners, and :func:`dist_solve`, which runs the unchanged Krylov
source on every rank.  :mod:`~repro_torch.distributed.comm` holds the
process group, its collectives and the world runner;
:mod:`~repro_torch.distributed.sharding` the padded-shard masking.
"""

from repro_torch.distributed import comm, sharding
from repro_torch.distributed.matrix import (
    DistCsr,
    DistEll,
    DistLinOp,
    LocalOperator,
    split_by_rows,
    stacked_host_arrays,
)
from repro_torch.distributed.partition import Partition
from repro_torch.distributed.precond import (
    DistBlockJacobi,
    DistScalarJacobi,
    dist_block_jacobi,
    dist_preconditioner,
    dist_scalar_jacobi,
)
from repro_torch.distributed.solvers import dist_solve
from repro_torch.distributed.vector import (
    DistVector,
    dist_axpy,
    dist_dot,
    dist_norm2,
    dist_scal,
)

__all__ = [
    "comm",
    "sharding",
    "Partition",
    "DistLinOp",
    "DistCsr",
    "DistEll",
    "LocalOperator",
    "DistVector",
    "DistScalarJacobi",
    "DistBlockJacobi",
    "split_by_rows",
    "stacked_host_arrays",
    "dist_preconditioner",
    "dist_scalar_jacobi",
    "dist_block_jacobi",
    "dist_solve",
    "dist_dot",
    "dist_norm2",
    "dist_axpy",
    "dist_scal",
]
