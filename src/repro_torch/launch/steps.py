"""Step factories: the port of ``repro/launch/steps.py``.

Training: ``make_train_step`` (one batch), ``make_grad_accum_train_step``
(microbatches accumulated in f32, then their mean) and
``make_compressed_dp_train_step`` (each rank of a data-parallel group runs
the step on its shard of the batch and the gradients are averaged by
:func:`repro_torch.optim.compressed_psum`, each rank keeping its own
error-feedback state; the optimizer then runs identically on every rank).
A training step takes a trainable parameter tree
(:func:`repro_torch.nn.common.trainable`) and updates it and the optimizer
state in place (see :mod:`repro_torch.optim.adamw`); the gradients come
from ``torch.autograd.grad`` of ``lm.loss_fn``, through the kernels.

Serving: ``make_prefill_step`` / ``make_decode_step`` return the last
position's logits (the next-token distribution) and the cache, which the
model updates in place.  A batch holds ``tokens``, or ``embeds`` for a
stub-frontend model.  The serving parameters stay frozen, so serving
records no autograd graph.

Shapes and shardings of a cell (``model_shapes_and_axes``,
``opt_state_shapes``, ``batch_struct``, ``cache_struct``,
``train_shardings``) are tensors on the ``meta`` device and the specs of
:mod:`repro_torch.distributed.sharding`.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import tree as tree_lib
from repro_torch.distributed import sharding as shd
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWState

__all__ = ["loss_and_grads", "make_train_step", "make_grad_accum_train_step",
           "make_compressed_dp_train_step", "make_prefill_step",
           "make_decode_step", "model_shapes_and_axes", "opt_state_shapes",
           "batch_struct", "cache_struct", "train_shardings"]


def loss_and_grads(params, cfg, batch, executor=None):
    """(loss, metrics, grads): ``lm.loss_fn`` and its gradient tree (zeros
    for a leaf the loss does not reach), all detached."""
    leaves = tree_lib.leaves(params)
    loss, metrics = lm.loss_fn(params, cfg, batch, executor=executor)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(grads, leaves))
    grads = tree_lib.tree_map(lambda _: next(it), params)
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def make_train_step(cfg, optimizer, executor=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics)."""

    def train_step(params, opt_state, batch):
        _, metrics, grads = loss_and_grads(params, cfg, batch, executor)
        params, opt_state, stats = optimizer.update(params, grads, opt_state)
        return params, opt_state, {**metrics, **stats}

    return train_step


def make_grad_accum_train_step(cfg, optimizer, num_microbatches: int,
                               executor=None):
    """Gradient accumulation: the batch split into ``num_microbatches``
    along its leading axis, their gradients summed in f32, then divided by
    the count (the optimizer sees f32 gradients, as in the JAX package)."""

    def train_step(params, opt_state, batch):
        def split(x):
            b = x.shape[0]
            return x.reshape(num_microbatches, b // num_microbatches,
                             *x.shape[1:])

        micro = {k: split(v) for k, v in batch.items()}
        g_acc = tree_lib.zeros_like_tree(params, torch.float32)
        loss_sum = 0.0
        for i in range(num_microbatches):
            mb = {k: v[i] for k, v in micro.items()}
            loss, _, grads = loss_and_grads(params, cfg, mb, executor)
            g_acc = tree_lib.tree_map(torch.add, g_acc, grads)
            loss_sum = loss_sum + loss
        grads = tree_lib.tree_map(lambda g: g / num_microbatches, g_acc)
        params, opt_state, stats = optimizer.update(params, grads, opt_state)
        stats = dict(stats)
        stats["loss"] = loss_sum / num_microbatches
        return params, opt_state, stats

    return train_step


def make_compressed_dp_train_step(cfg, optimizer, group=None, executor=None):
    """Explicit data parallelism with int8 error-feedback gradient
    compression over ``group`` (the default group when None).

    Returns ``train_step(params, opt_state, err_state, batch_local)`` and
    ``init_err_state(params)``: every rank calls the step on its own shard
    of the batch with its own error state; parameters and optimizer state
    stay replicated (the same compressed gradients reach every rank).  The
    stats are ``loss`` (averaged over the group), ``lr``, ``grad_norm`` and
    ``param_norm``."""
    from repro_torch.distributed import comm
    from repro_torch.optim.compression import compressed_psum

    def init_err_state(params):
        return tree_lib.zeros_like_tree(params, torch.float32)

    def train_step(params, opt_state, err_state, batch):
        loss, _, grads = loss_and_grads(params, cfg, batch, executor)
        grads, err_state = compressed_psum(grads, err_state, group)
        n = 1
        if comm._initialized():
            import torch.distributed as dist

            n = dist.get_world_size(group)
        loss = comm.all_reduce(loss, "sum", group) / n
        params, opt_state, stats = optimizer.update(params, grads, opt_state)
        stats = dict(stats)
        stats["loss"] = loss
        return params, opt_state, err_state, stats

    return train_step, init_err_state


def make_prefill_step(cfg, executor=None):
    def prefill_step(params, batch, cache):
        logits, cache = lm.prefill(params, cfg, tokens=batch.get("tokens"),
                                   embeds=batch.get("embeds"), cache=cache,
                                   executor=executor)
        # a copy: the (B, S, vocab) logits are freed on return
        return logits[:, -1, :].contiguous(), cache

    return prefill_step


def make_decode_step(cfg, executor=None):
    def decode_step(params, batch, length, cache):
        logits, cache = lm.decode_step(params, cfg, tokens=batch.get("tokens"),
                                       embeds=batch.get("embeds"),
                                       length=length, cache=cache,
                                       executor=executor)
        return logits[:, -1, :], cache

    return decode_step


# =============================================================================
# shapes + shardings for a (cfg, shape, mesh) cell
# =============================================================================


def model_shapes_and_axes(cfg):
    """Parameter shapes (``meta`` tensors) and logical axes, no storage."""
    return lm.init_model(cfg, device="meta"), lm.model_axes(cfg)


def opt_state_shapes(optimizer, param_shapes):
    return optimizer.init(param_shapes)


def batch_struct(cfg, global_batch: int, seq_len: int) -> Dict[str, torch.Tensor]:
    toks = torch.empty((global_batch, seq_len), dtype=torch.int32,
                       device="meta")
    out = {"labels": toks}
    if cfg.frontend == "stub_embeddings":
        out["embeds"] = torch.empty((global_batch, seq_len, cfg.d_model),
                                    dtype=lm._dtype(cfg), device="meta")
    else:
        out["tokens"] = toks
    return out


def cache_struct(cfg, batch: int, s_max: int):
    return lm.init_cache(cfg, batch, s_max, device="meta")


def train_shardings(mesh, cfg, optimizer, *, zero: str = "zero1"):
    """(shapes, axes, param specs, optimizer-state shapes, optimizer-state
    specs) for the cell."""
    shapes, axes = model_shapes_and_axes(cfg)
    p_sh = shd.param_shardings(mesh, shapes, axes,
                               zero="fsdp" if zero == "fsdp" else "none")
    opt_shapes = opt_state_shapes(optimizer, shapes)
    m_zero = "zero1" if zero in ("zero1", "fsdp") else "none"
    mu_sh = shd.moment_shardings(mesh, opt_shapes.mu, axes, zero=m_zero)
    nu_sh = shd.moment_shardings(mesh, opt_shapes.nu, axes, zero=m_zero)
    opt_sh = AdamWState(step=shd.replicated(mesh), mu=mu_sh, nu=nu_sh)
    return shapes, axes, p_sh, opt_shapes, opt_sh
