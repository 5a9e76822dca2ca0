"""Differentiable collectives for a model split over a process group.

The JAX package writes a parallel layer as a ``shard_map`` body and lets
``jax.grad`` transpose its collectives.  The port runs the body on every
rank of a group and marks where a tensor enters or leaves the split part,
the convention of tensor-parallel training: the computation outside is
replicated on every rank of the group, and each rank's gradient of a
replicated tensor is the whole gradient.

* :func:`enter` — a replicated tensor used by the split part: identity
  forward, all-reduce (sum) of the rank's partial gradient backward;
* :func:`leave` — the split part's partial result: all-reduce (sum)
  forward, identity backward;
* :func:`mean` — a mean over the group, backward divided by ``grad_div``
  (the group's size when the value's cotangent is replicated over it, 1
  over data ranks whose gradients a data-parallel step averages);
* :func:`take` — this rank's slice of a replicated tensor (an expert
  block, a sequence shard): a view forward; backward the slice's gradient
  placed in zeros and all-reduced, so every rank holds the whole gradient;
* :func:`gather` — all-gather along a dimension forward, this rank's slice
  of the gradient backward;
* :func:`all_to_all` — the exchange of row blocks, its own transpose.

Without a process group (``group`` None) each is the identity.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import comm

__all__ = ["enter", "leave", "mean", "take", "gather", "all_to_all",
           "group_rank", "group_size"]


def group_size(group) -> int:
    if isinstance(group, comm.CensusGroup):
        return group.size
    if group is None or not comm._initialized():
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


def group_rank(group) -> int:
    if isinstance(group, comm.CensusGroup):
        return 0
    if group is None or not comm._initialized():
        return 0
    import torch.distributed as dist

    return dist.get_rank(group)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce(g, "sum", ctx.group), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return comm.all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad_div):
        ctx.grad_div = grad_div
        return comm.all_reduce(x, "sum", group) / group_size(group)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.grad_div, None, None


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, start, length, group):
        ctx.meta = (x.shape, dim, start, length, group)
        return x.narrow(dim, start, length)

    @staticmethod
    def backward(ctx, g):
        shape, dim, start, length, group = ctx.meta
        full = g.new_zeros(shape)
        full.narrow(dim, start, length).copy_(g)
        return comm.all_reduce(full, "sum", group), None, None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.meta = (dim, x.shape[dim], group_rank(group))
        parts = comm.all_gather(x, group)
        return torch.cat(list(parts.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        dim, n, r = ctx.meta
        return g.narrow(dim, r * n, n).contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return comm.all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return comm.all_to_all(g.contiguous(), ctx.group), None


def enter(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _Enter.apply(x, group)


def leave(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _Leave.apply(x, group)


def mean(x: torch.Tensor, group, grad_div: float = 1.0) -> torch.Tensor:
    return x if group is None else _Mean.apply(x, group, float(grad_div))


def take(x: torch.Tensor, dim: int, start: int, length: int,
         group) -> torch.Tensor:
    if group is None:
        return x.narrow(dim, start, length)
    return _Take.apply(x, dim, start, length, group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _Gather.apply(x, dim, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Leading axis: one block a rank of ``group``."""
    return x if group is None else _AllToAll.apply(x, group)
