"""Ring collective matmuls over a process group: the port of
``repro/distributed/collective_matmul.py``.

``ring_reduce_scatter_matmul`` computes ``y = sum_r x_r @ w_r`` reduce-
scattered over the group (each rank ends with its output-column chunk);
``ring_all_gather_matmul`` computes ``all_gather(x) @ w_local`` with x
row-sharded, never holding the whole x.  Each is ``size`` steps of one
partial product and one exchange with the ring neighbours
(:func:`repro_torch.distributed.comm.ring_shift`, a ``batch_isend_irecv``
pair: rank i sends to i + 1), in the JAX package's chunk order, so every
rank's partial sums add in the same order as there.  Without a process
group (or a group of one) they are plain products.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import comm

__all__ = ["ring_reduce_scatter_matmul", "ring_all_gather_matmul"]


def _size_rank(group):
    """(size, this rank's index) of ``group``, the default group when None;
    (1, 0) without a process group."""
    if not comm._initialized():
        return 1, 0
    import torch.distributed as dist

    return dist.get_world_size(group), dist.get_rank(group)


def ring_reduce_scatter_matmul(x: torch.Tensor, w: torch.Tensor,
                               group=None) -> torch.Tensor:
    """x (m, k_local), w (k_local, n) -> (m, n / size): this rank's columns
    of ``sum over ranks of x @ w``."""
    size, rank = _size_rank(group)
    n = w.shape[1]
    if n % size:
        raise ValueError(f"output dim {n} not divisible by group size {size}")
    chunk = n // size

    def chunk_of(i):
        # the accumulator bound for rank r sits at rank q = r + 1 + i at
        # step i, so rank q adds chunk r = q - 1 - i; it reaches its owner
        # on the last step
        idx = (rank - 1 - i) % size
        return w[:, idx * chunk:(idx + 1) * chunk]

    acc = x @ chunk_of(0)
    for i in range(1, size):
        acc = comm.ring_shift(acc, group)
        acc = acc + x @ chunk_of(i)
    return acc


def ring_all_gather_matmul(x: torch.Tensor, w: torch.Tensor,
                           group=None) -> torch.Tensor:
    """x (m_local, k) row shard, w (k, n_local) -> (m_local * size,
    n_local) = all_gather(x) @ w."""
    size, rank = _size_rank(group)
    m_local = x.shape[0]
    out = torch.zeros((m_local * size, w.shape[1]), dtype=x.dtype,
                      device=x.device)
    chunk_x = x
    for i in range(size):
        src = (rank - i) % size  # whose rows this rank holds now
        out[src * m_local:(src + 1) * m_local] = (chunk_x @ w).to(out.dtype)
        if i + 1 < size:
            chunk_x = comm.ring_shift(chunk_x, group)
    return out
