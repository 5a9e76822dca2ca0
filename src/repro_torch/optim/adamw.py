"""AdamW, LR schedules and global-norm clipping: the port of
``repro/optim/adamw.py`` (no ``torch.optim``, as the JAX package has no
optax).

The JAX package's functional contract::

    opt = adamw(schedule, weight_decay=0.1, clip_norm=1.0)
    state = opt.init(params)
    params, state, stats = opt.update(params, grads, state)

over trees of tensors (:mod:`repro_torch.core.tree`): a
:class:`~repro_torch.nn.common.ParamTree`, nested dicts and lists.  The
update keeps the JAX package's arithmetic: moments in ``moment_dtype`` (f32),
each parameter updated in f32 and cast back to its own dtype (a bf16
parameter has no f32 master copy).  Unlike JAX's immutable arrays, the port
writes the new parameters and moments into the tensors it is given and
returns them, so a step holds one copy of each.  A schedule maps the step
(an int32 tensor on the parameters' device) to an f32 tensor, computed
there: a step reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import tree as tree_lib

__all__ = ["AdamWState", "Optimizer", "adamw", "clip_by_global_norm",
           "constant_schedule", "global_norm", "warmup_cosine_schedule",
           "warmup_linear_schedule"]

Schedule = Callable[[torch.Tensor], torch.Tensor]


# -- schedules ---------------------------------------------------------------------


def constant_schedule(lr: float) -> Schedule:
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                           final_frac: float = 0.1) -> Schedule:
    def schedule(step):
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)

    return schedule


def warmup_linear_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int) -> Schedule:
    def schedule(step):
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        return torch.where(step < warmup_steps, warm, peak_lr * (1 - prog))

    return schedule


# -- optimizer -----------------------------------------------------------------------


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor  # scalar int32
    mu: Any  # first moment (params-shaped)
    nu: Any  # second moment (params-shaped)


class Optimizer(NamedTuple):
    init: Callable[[Any], AdamWState]
    update: Callable[..., Tuple[Any, AdamWState, Dict[str, torch.Tensor]]]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x^2), in f32."""
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in tree_lib.leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by min(1, max_norm / (norm + 1e-9)), each leaf in its own
    dtype; the norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_lib.tree_map(lambda x: (x * scale).to(x.dtype), tree), norm


def adamw(schedule: Schedule, *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: Optional[float] = 1.0,
          moment_dtype: torch.dtype = torch.float32) -> Optimizer:
    def init(params) -> AdamWState:
        first = tree_lib.leaves(params)[0]
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=first.device),
            mu=tree_lib.zeros_like_tree(params, moment_dtype),
            nu=tree_lib.zeros_like_tree(params, moment_dtype),
        )

    @torch.no_grad()
    def update(params, grads, state: AdamWState):
        stats: Dict[str, torch.Tensor] = {}
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        else:
            gnorm = global_norm(grads)
        stats["grad_norm"] = gnorm

        step = state.step + 1
        lr = schedule(step)
        stats["lr"] = lr
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=stepf.device), stepf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=stepf.device), stepf)

        for p, g, mu, nu in zip(tree_lib.leaves(params), tree_lib.leaves(grads),
                                tree_lib.leaves(state.mu),
                                tree_lib.leaves(state.nu)):
            g32 = g.to(moment_dtype)
            mu.copy_(b1 * mu + (1 - b1) * g32)
            nu.copy_(b2 * nu + (1 - b2) * torch.square(g32))
            mu_hat = mu / bc1
            nu_hat = nu / bc2
            step_val = (mu_hat / (torch.sqrt(nu_hat) + eps)
                        + weight_decay * p.to(moment_dtype))
            p.copy_((p.to(moment_dtype) - lr * step_val).to(p.dtype))
        state.step = step
        stats["param_norm"] = global_norm(params)
        return params, state, stats

    return Optimizer(init=init, update=update)
