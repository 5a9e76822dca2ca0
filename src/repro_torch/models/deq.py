"""Deep-equilibrium regression model: a sparse implicit solve as the middle layer.

The model joins the solver half and the NN half of the repo.  An input
feature vector ``u`` is lifted to a right-hand side ``b = W_in u``, pushed
through the implicit layer ``x = A(theta)^{-1} b`` (a GMRES solve with the
adjoint backward through the Transpose combinator, :mod:`repro_torch.nn.implicit`)
and read out as ``y = w_out . x``.  The operator is an upwind
convection-diffusion stencil with a diagonal shift, perturbed by the
trainable ``theta``:

    values = base + shift * (diag mask) + scale * tanh(theta)

``tanh`` bounds the perturbation, so the shifted operator keeps a strict
diagonal-dominance margin (shift > scale * max row nnz) and GMRES converges
for every parameter value an optimizer can reach.

Training data is teacher-student: targets come from the same architecture
with a hidden ``theta*``, so the loss has a known minimum.  The JAX package
draws ``W_in`` / ``w_out`` from ``jax.random``, which the port cannot
reproduce: :func:`init_deq` draws from an explicit ``torch.Generator``, and
:func:`repro_torch.convert.deq_params_from_jax` carries JAX parameters across.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.executor import default_device
from repro_torch.nn.implicit import make_implicit_solve
from repro_torch.solvers.common import Stop
from repro_torch.sparse.gallery import convection_diffusion_2d

__all__ = ["DeqConfig", "init_deq", "deq_forward", "deq_loss",
           "synthetic_batch"]

_SHIFT = 1.0  # diagonal shift: dominance margin
_SCALE = 0.05  # tanh perturbation scale; 5 nnz/row * 0.05 << shift

#: the teacher's seed, as in the JAX package
_TEACHER_SEED = 7


class DeqConfig:
    """Static configuration: grid side, input width, solver tolerances, and
    where the model runs (the card unless ``device="cpu"`` and a CPU
    executor are asked for)."""

    def __init__(self, n_side: int = 8, d_in: int = 4, peclet: float = 2.0,
                 restart: int = 20, tol: float = 1e-8, *, device=None,
                 executor=None, dtype: torch.dtype = torch.float32):
        self.n_side = n_side
        self.d_in = d_in
        self.peclet = peclet
        self.restart = restart
        self.tol = tol
        self.device = torch.device(device) if device is not None else default_device()
        self.dtype = dtype
        indptr, indices, values, shape = convection_diffusion_2d(
            n_side, peclet=peclet, scheme="upwind")
        rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
        base = values.astype(np.float32).copy()
        base[rows == indices] += _SHIFT
        self.indptr = indptr
        self.indices = indices
        self.base_values = torch.as_tensor(base, device=self.device).to(dtype)
        self.n = shape[0]
        self.nnz = len(values)
        self.solve = make_implicit_solve(
            indptr, indices, shape, restart=restart,
            stop=Stop(max_iters=400, reduction_factor=tol), executor=executor)


def init_deq(generator: torch.Generator, cfg: DeqConfig) -> Dict[str, torch.Tensor]:
    """``theta`` zero, ``w_in`` / ``w_out`` scaled normal draws from
    ``generator`` (a CPU generator; the draws then move to ``cfg.device``)."""
    w_in = torch.randn((cfg.n, cfg.d_in), generator=generator) / np.sqrt(cfg.d_in)
    w_out = torch.randn((cfg.n,), generator=generator) / np.sqrt(cfg.n)
    return {
        "theta": torch.zeros(cfg.nnz, dtype=cfg.dtype, device=cfg.device),
        "w_in": w_in.to(cfg.device, cfg.dtype),
        "w_out": w_out.to(cfg.device, cfg.dtype),
    }


def deq_forward(params: Dict[str, torch.Tensor], u: torch.Tensor,
                cfg: DeqConfig) -> torch.Tensor:
    """``u`` is (batch, d_in); returns (batch,) predictions.  One implicit
    solve a sample (the JAX package's ``vmap``)."""
    values = cfg.base_values + _SCALE * torch.tanh(params["theta"])
    b = u @ params["w_in"].T  # (batch, n)
    x = torch.stack([cfg.solve(values, bi) for bi in b])
    return x @ params["w_out"]


def deq_loss(params, batch: Tuple[torch.Tensor, torch.Tensor],
             cfg: DeqConfig) -> torch.Tensor:
    u, y = batch
    pred = deq_forward(params, u, cfg)
    return torch.mean(torch.square(pred - y))


def synthetic_batch(seed: int, batch_size: int, cfg: DeqConfig,
                    teacher: Optional[Dict[str, torch.Tensor]] = None):
    """Teacher-student data: ``u`` from ``numpy.random.default_rng(seed)``
    (the JAX package's draws), targets from the teacher's forward.  The
    teacher defaults to :func:`init_deq` of a generator seeded 7 with
    ``theta*`` from ``default_rng(7)`` (the JAX package's ``theta*``; its
    ``W_in`` / ``w_out`` come from ``jax.random``)."""
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.standard_normal((batch_size, cfg.d_in))
                        .astype(np.float32), device=cfg.device).to(cfg.dtype)
    if teacher is None:
        teacher = init_deq(torch.Generator().manual_seed(_TEACHER_SEED), cfg)
        teacher["theta"] = torch.as_tensor(
            np.random.default_rng(_TEACHER_SEED).standard_normal(cfg.nnz)
            .astype(np.float32), device=cfg.device).to(cfg.dtype)
    with torch.no_grad():
        y = deq_forward(teacher, u, cfg)
    return u, y
