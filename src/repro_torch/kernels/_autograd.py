"""Gradients through the hand-written kernels: the kernel forward, the plain
version's backward.

A kernel wrapper launches its kernel through ``ctypes`` on raw pointers into
a fresh output, so autograd sees no operation: the output has no
``grad_fn``.  :func:`kernel_call` wraps such a call in
:class:`RecomputeFunction` when an input needs a gradient:

* forward: the kernel, exactly as without autograd (the same output bits
  and the same launch count);
* it saves its inputs only;
* backward: recomputes the kernel's plain PyTorch version from the saved
  inputs under ``torch.enable_grad()`` and returns ``torch.autograd.grad``
  of it, so no hand-written kernel runs in backward and the plain
  version's intermediates live only while one call's backward runs.

The JAX package differentiates the same way (``jax.grad`` through whatever
the executor runs); it has no backward kernel, and neither has the port.
When no input needs a gradient (serving, ``torch.no_grad()``), the kernel is
called bare and nothing is recorded.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

__all__ = ["RecomputeFunction", "kernel_call", "needs_grad"]


def needs_grad(tensors: Sequence[torch.Tensor]) -> bool:
    """Whether autograd would record an operation on ``tensors``."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


class RecomputeFunction(torch.autograd.Function):
    """``apply(kernel, plain, *inputs)``: ``kernel(*inputs)`` forward, the
    gradient of ``plain(*inputs)`` backward.  Both return a tensor or a tuple
    of tensors of the same shapes; an output whose gradient is not asked for
    (a scan's final state in training) is left out of the backward."""

    @staticmethod
    def forward(ctx, kernel: Callable, plain: Callable, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)
        out = kernel(*inputs)
        ctx.tuple_out = isinstance(out, tuple)
        return out

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        wanted = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(w) if w else t.detach()
                  for t, w in zip(inputs, wanted)]
            outs = ctx.plain(*xs)
            if not ctx.tuple_out:
                outs = (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            wrt = [x for x, w in zip(xs, wanted) if w]
            if pairs and wrt:
                got = iter(torch.autograd.grad(
                    [o for o, _ in pairs], wrt, [g for _, g in pairs],
                    allow_unused=True))
            else:
                got = iter([None] * len(wrt))
        return (None, None) + tuple(next(got) if w else None for w in wanted)


def kernel_call(kernel: Callable, plain: Callable, *inputs: torch.Tensor):
    """``kernel(*inputs)``, differentiable through ``plain`` when an input
    needs a gradient; the bare kernel call otherwise."""
    if needs_grad(inputs):
        return RecomputeFunction.apply(kernel, plain, *inputs)
    return kernel(*inputs)
