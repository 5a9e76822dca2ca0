"""Distributed vectors — gko::experimental::distributed::Vector.

A :class:`DistVector` is this rank's padded shard of a global vector: shape
``(Lmax,)``, padding slots zero, plus the partition and the rank (the JAX
package's ``(P, Lmax)`` stack, of which each rank holds one row).
``axpy``/``scal`` are shard-local; ``dot``/``norm2`` reduce locally through
the executor-dispatched ops and then sum over the ranks, with the padding
masked (:func:`repro_torch.sparse.ops.distributed_blas`), so a ragged
partition never counts a padding slot.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.distributed import comm
from repro_torch.distributed.partition import Partition

__all__ = ["DistVector", "dist_dot", "dist_norm2", "dist_axpy", "dist_scal",
           "local_mask"]


def local_mask(partition: Partition, rank: int, device) -> Optional[torch.Tensor]:
    """Rank ``rank``'s row of the pad mask as a bool tensor on ``device``;
    None when its shard has no padding."""
    if not partition.is_padded(rank):
        return None
    return torch.as_tensor(partition.pad_mask[rank], device=device)


def check_world(partition: Partition) -> int:
    """This process's rank; raises unless the world has one rank a part."""
    rank, size = comm.world()
    if size != partition.num_parts:
        raise ValueError(
            f"a partition of {partition.num_parts} parts needs a world of as "
            f"many ranks, this one has {size}")
    return rank


@dataclasses.dataclass(frozen=True)
class DistVector:
    """This rank's padded shard of a global vector (+ its partition)."""

    local: torch.Tensor  # (Lmax,), padding slots zero
    partition: Partition
    rank: int

    @classmethod
    def from_global(cls, x: torch.Tensor, partition: Partition) -> "DistVector":
        rank = check_world(partition)
        return cls(local=partition.pad_part(x, rank), partition=partition,
                   rank=rank)

    def to_global(self) -> torch.Tensor:
        """The global vector, on every rank (one all-gather)."""
        return self.partition.unpad_flat(
            comm.all_gather_shards(self.local, kind="gather"))

    @property
    def mask(self) -> Optional[torch.Tensor]:
        return local_mask(self.partition, self.rank, self.local.device)


def _check_same_partition(x: DistVector, y: DistVector) -> None:
    if x.partition != y.partition:
        # equal shard shapes can still lay out different global rows
        raise ValueError(
            f"DistVector partitions differ ({x.partition.offsets} vs "
            f"{y.partition.offsets}); repartition one operand first"
        )


def dist_dot(x: DistVector, y: DistVector, *, executor=None) -> torch.Tensor:
    """Global ``<x, y>``: the local dispatched dot, summed over the ranks."""
    from repro_torch.sparse import ops as sparse_ops

    _check_same_partition(x, y)
    with sparse_ops.distributed_blas(x.mask):
        return sparse_ops.dot(x.local, y.local, executor=executor)


def dist_norm2(x: DistVector, *, executor=None) -> torch.Tensor:
    """Global ``||x||_2``: the masked local sum of squares, summed over the
    ranks, one sqrt."""
    from repro_torch.sparse import ops as sparse_ops

    with sparse_ops.distributed_blas(x.mask):
        return sparse_ops.norm2(x.local, executor=executor)


def dist_axpy(alpha, x: DistVector, y: DistVector, *, executor=None) -> DistVector:
    """``alpha * x + y`` — shard-local, no communication."""
    from repro_torch.sparse import ops as sparse_ops

    _check_same_partition(x, y)
    return dataclasses.replace(
        y, local=sparse_ops.axpy(alpha, x.local, y.local, executor=executor))


def dist_scal(alpha, x: DistVector, *, executor=None) -> DistVector:
    """``alpha * x`` — shard-local, no communication."""
    from repro_torch.sparse import ops as sparse_ops

    return dataclasses.replace(
        x, local=sparse_ops.scal(alpha, x.local, executor=executor))
