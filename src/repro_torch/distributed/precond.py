"""Rank-local preconditioners for distributed solves.

Distributed block-Jacobi is block-local by construction: each rank builds
its preconditioner from its own padded diagonal block and applies it with no
communication — how Ginkgo applies ``preconditioner::Jacobi`` to a
``distributed::Matrix``.  Generation reuses the single-card generators
(:func:`repro_torch.solvers.common.jacobi_preconditioner`,
:func:`repro_torch.precond.block_jacobi`) on the rank's block, so on the
card the apply is the CUDA ``block_jacobi_apply`` kernel.  Padding rows
carry a zero diagonal, which both generators turn into an identity action on
slots that stay zero.

Storage precision must be one dtype on every rank (an explicit
``adaptive="float16"``); ``adaptive=True`` is refused, as in the JAX
package, because the per-block rule could split each rank's blocks into
different precision classes.
"""

from __future__ import annotations

from typing import Union

from repro_torch.core.linop import Identity, LinOp
from repro_torch.distributed import comm
from repro_torch.distributed.partition import Partition

__all__ = ["DistScalarJacobi", "DistBlockJacobi", "dist_preconditioner",
           "dist_scalar_jacobi", "dist_block_jacobi"]


class _DistPrecond(LinOp):
    """This rank's preconditioner ``local`` (a LinOp on padded shards) and
    the partition; the global apply pads, applies and gathers."""

    is_distributed = True

    def __init__(self, local: LinOp, partition: Partition, rank: int):
        self.local = local
        self.partition = partition
        self.rank = rank

    @property
    def shape(self):
        n = self.partition.global_size
        return (n, n)

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def storage_bytes(self) -> int:
        return self.local.storage_bytes

    def local_operator(self, executor=None) -> LinOp:
        return self.local

    def _apply(self, v, executor):
        # rank-local: pad this rank's rows, apply, gather the global vector
        part = self.partition
        y = self.local.apply(part.pad_part(v, self.rank), executor=executor)
        return part.unpad_flat(comm.all_gather_shards(y, kind="gather"))


class DistScalarJacobi(_DistPrecond):
    """Rank-local scalar Jacobi: ``M^-1 v = inv_diag * v`` on each shard."""


class DistBlockJacobi(_DistPrecond):
    """Rank-local block-Jacobi in one storage precision: each rank applies a
    plain :class:`repro_torch.precond.BlockJacobi` of its own block."""


def _refuse_adaptive(kind: str, adaptive) -> None:
    if adaptive is True:
        raise ValueError(
            f"distributed {kind} needs a uniform storage precision across "
            "ranks: pass an explicit dtype (adaptive='float16') instead of "
            "adaptive=True")


def dist_scalar_jacobi(A, *, adaptive: Union[bool, str] = False,
                       executor=None) -> DistScalarJacobi:
    """Rank-local scalar Jacobi from ``A``'s local block."""
    from repro_torch.solvers.common import jacobi_preconditioner

    _refuse_adaptive("scalar Jacobi", adaptive)
    return DistScalarJacobi(
        jacobi_preconditioner(A.local_block(), executor=executor,
                              adaptive=adaptive),
        A.partition, A.rank)


def dist_block_jacobi(A, block_size: int = None, *,
                      adaptive: Union[bool, str] = False,
                      executor=None) -> DistBlockJacobi:
    """Rank-local block-Jacobi from ``A``'s local block."""
    from repro_torch.precond import block_jacobi

    _refuse_adaptive("block-Jacobi", adaptive)
    bj = block_jacobi(A.local_block(), block_size=block_size,
                      adaptive=adaptive, executor=executor)
    if len(bj.inv_blocks) != 1:  # False or an explicit dtype gives one class
        raise ValueError(f"block-Jacobi of rank {A.rank} has "
                         f"{len(bj.inv_blocks)} storage classes, not one")
    return DistBlockJacobi(bj, A.partition, A.rank)


def dist_preconditioner(A, kind, *, executor=None, **opts):
    """Resolve a distributed solve's ``M=``: ``None`` / ``"identity"`` -> no
    preconditioner; ``"jacobi"`` / ``"block_jacobi"`` build rank-locally from
    ``A``'s local block; a distributed LinOp on ``A``'s partition passes
    through.  A LinOp that is not distributed, or a callable, is refused: it
    cannot apply rank-locally."""
    if kind is None or isinstance(kind, Identity):
        if opts:
            raise ValueError(
                f"identity preconditioner takes no options, got {sorted(opts)}")
        return None
    if isinstance(kind, str):
        if kind == "identity":
            return dist_preconditioner(A, None, executor=executor, **opts)
        if kind == "jacobi":
            return dist_scalar_jacobi(A, executor=executor, **opts)
        if kind == "block_jacobi":
            return dist_block_jacobi(A, executor=executor, **opts)
        raise ValueError(
            f"unknown distributed preconditioner kind {kind!r} "
            "(identity | jacobi | block_jacobi)")
    if getattr(kind, "is_distributed", False):
        if opts:
            raise ValueError(
                "precond_opts is only meaningful when M is a kind name")
        m_part = getattr(kind, "partition", None)
        if m_part is not None and m_part != A.partition:
            # equal part counts with other offsets would apply each rank's
            # inverse to the wrong rows
            raise ValueError(
                f"preconditioner partition {m_part.offsets} does not match "
                f"the matrix partition {A.partition.offsets}; regenerate the "
                "preconditioner against this matrix")
        return kind
    raise TypeError(
        f"{type(kind).__name__} cannot precondition a distributed solve: "
        "pass a kind name ('jacobi' / 'block_jacobi') or a distributed "
        "preconditioner built against the matrix's partition")
