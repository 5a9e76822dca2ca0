"""Padded-shard reduction hygiene, the solver half of the JAX package's
``distributed/sharding.py``.

Distributed vectors are padded to one per-rank length (``Lmax``); the padding
slots must stay out of every cross-rank reduction, or a ragged partition
counts whatever sits in them (the padded-shard bug).  The distributed BLAS
(:func:`repro_torch.sparse.ops.distributed_blas`) passes every reduction
operand through :func:`zero_shard_padding`, so a reduction is right even
when a padding slot holds garbage.

The parameter, moment, cache and batch sharding rules of the JAX module
serve the training steps and come with them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["axis_size", "shard_pad_mask", "zero_shard_padding"]


def axis_size(group=None) -> int:
    """Ranks of ``group`` (the default group when None): the counterpart of
    ``jax.lax.axis_size`` over the data axis.  1 without a process group."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def shard_pad_mask(part_sizes: Sequence[int], max_size: int) -> np.ndarray:
    """(P, max_size) bool mask — True on real slots, False on padding."""
    sizes = np.asarray(part_sizes, np.int64)
    if max_size < (int(sizes.max()) if sizes.size else 0):
        raise ValueError(
            f"max_size {max_size} smaller than largest part {sizes.max()}"
        )
    return np.arange(max_size, dtype=np.int64)[None, :] < sizes[:, None]


def zero_shard_padding(x: torch.Tensor,
                       mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero the padding slots of a padded shard; ``mask`` is this rank's row
    of :func:`shard_pad_mask` as a bool tensor, ``None`` for a shard without
    padding (``x`` is returned as it is)."""
    if mask is None:
        return x
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))
