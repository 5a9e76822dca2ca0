"""Rank bodies of the training path's distributed parts.

:func:`run_train_cases` is what :func:`repro_torch.distributed.comm.run_world`
spawns to check them against a single-process reference: every rank builds
the same inputs from the same host arrays, runs each case and returns
numpy arrays, which the caller holds against the JAX package's (under
``vmap`` with an axis name) or the port's dense results.  It lives in the
package because a spawned rank imports its function by module and name.

A case is a dict with ``op`` one of

* ``"compressed_psum"`` — ``g`` (P, ...) and ``err`` (P, ...) host arrays,
  row ``rank`` this rank's: ``{"mean", "err"}``;
* ``"ring_rs"`` / ``"ring_ag"`` — ``x``, ``w`` whole host matrices, cut
  as the JAX test cuts them (contraction / rows over the ranks):
  ``{"y"}`` this rank's block;
* ``"moe_ep"`` — ``cfg`` (ModelConfig fields), ``mesh`` ({"data": D,
  "model": M}), ``seed``, ``x`` (B, S, d): the rank's data shard through
  ``impl="ep"``, the loss sum(y^2): ``{"y", "metrics", "grads", "dx"}``;
* ``"census_step"`` — ``arch`` (its smoke config, expert-parallel over
  the mesh's model axis), ``mesh``, ``batch`` (B, S) host tokens: one
  ``make_train_step`` on the rank's data shard of seed-0 weights, and the
  training collectives it issued: ``{"counts", "bytes"}``;
* ``"compressed_dp"`` — ``arch``, ``steps``, ``global_batch``, ``seq_len``,
  ``lr`` and optionally ``smoke``, ``n_layers``, ``data_seed``, ``dtype``:
  :func:`compressed_dp_run` on the rank.

Every case runs on the ``device`` the caller names.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

__all__ = ["run_train_cases", "compressed_dp_run", "dp_weights",
           "param_digest"]


def _np(t) -> np.ndarray:
    return t.detach().cpu().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


def _rank():
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size()


def _compressed_psum(case, device):
    from repro_torch.optim import compressed_psum

    r, _ = _rank()
    g = {"g": torch.as_tensor(np.asarray(case["g"])[r], device=device)}
    e = {"g": torch.as_tensor(np.asarray(case["err"])[r], device=device)}
    mean, err = compressed_psum(g, e)
    return {"mean": _np(mean["g"]), "err": _np(err["g"])}


def _ring(case, device):
    from repro_torch.distributed.collective_matmul import (
        ring_all_gather_matmul, ring_reduce_scatter_matmul)

    r, P = _rank()
    x = torch.as_tensor(np.asarray(case["x"]), device=device)
    w = torch.as_tensor(np.asarray(case["w"]), device=device)
    if case["op"] == "ring_rs":
        k = x.shape[1] // P
        y = ring_reduce_scatter_matmul(x[:, r * k:(r + 1) * k],
                                       w[r * k:(r + 1) * k])
    else:
        m, n = x.shape[0] // P, w.shape[1] // P
        y = ring_all_gather_matmul(x[r * m:(r + 1) * m],
                                   w[:, r * n:(r + 1) * n])
    return {"y": _np(y)}


def _moe_ep(case, device):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import tree as tree_lib
    from repro_torch.launch.mesh import make_mesh, use_mesh
    from repro_torch.nn import moe
    from repro_torch.nn.common import Initializer

    cfg = ModelConfig(**case["cfg"])
    mesh = make_mesh(case["mesh"])
    ini = Initializer(torch.Generator(device).manual_seed(case["seed"]),
                      torch.float32, device)
    p = {k: v.requires_grad_(True) for k, v in moe.moe_init(ini, cfg).items()}
    x = torch.as_tensor(np.asarray(case["x"]), device=device)
    D = mesh.shape["data"]
    b = x.shape[0] // D
    d = mesh.coords["data"]
    x_l = x[d * b:(d + 1) * b].clone().requires_grad_(True)
    with use_mesh(mesh):
        y, metrics = moe.moe_forward(p, x_l, cfg, impl="ep")
    loss = torch.sum(y ** 2)
    keys = list(p)
    grads = torch.autograd.grad(loss, [p[k] for k in keys] + [x_l])
    return {"y": _np(y), "metrics": {k: float(v.detach()) for k, v in metrics.items()},
            "grads": {k: _np(g) for k, g in zip(keys, grads[:-1])},
            "dx": _np(grads[-1]),
            "params": {k: _np(v) for k, v in p.items()}}


def _census_step(case, device):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import make_executor
    from repro_torch.distributed import comm
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_mesh, use_mesh
    from repro_torch.models import lm
    from repro_torch.nn.common import trainable
    from repro_torch.optim import adamw, warmup_cosine_schedule

    cfg = dataclasses.replace(get_smoke_config(case["arch"]),
                              moe_spec=(("data",), "model"))
    mesh = make_mesh(case["mesh"])
    params = trainable(lm.init_model(cfg, device=device))
    opt = adamw(warmup_cosine_schedule(3e-4, 10, 100))
    tokens = torch.as_tensor(np.asarray(case["batch"]), device=device)
    b = tokens.shape[0] // mesh.shape["data"]
    d = mesh.coords["data"]
    local = tokens[d * b:(d + 1) * b]
    step = steps_lib.make_train_step(cfg, opt, executor=make_executor(
        "torch", device=device))
    opt_state = opt.init(params)
    comm.reset_collective_counts()
    with use_mesh(mesh):
        step(params, opt_state, {"tokens": local, "labels": local})
    counts, nbytes = comm.collective_counts(), comm.collective_bytes()
    return {"counts": {k: counts[k] for k in comm.TRAIN_KINDS},
            "bytes": {k: nbytes[k] for k in comm.TRAIN_KINDS}}


def _host_truncated_normal(rs, shape, std, dtype, device):
    """std * (a standard normal truncated to [-2, 2], redrawn outside),
    from a numpy ``RandomState``."""
    x = rs.standard_normal(shape)
    out = np.abs(x) > 2.0
    while out.any():
        x[out] = rs.standard_normal(int(out.sum()))
        out = np.abs(x) > 2.0
    return torch.from_numpy((x * std).astype(np.float32)).to(dtype=dtype,
                                                             device=device)


def dp_weights(cfg, device, seed: int = 0):
    """Weights with :func:`~repro_torch.models.lm.init_model`'s rules, the
    truncated normals drawn from ``numpy.random.RandomState(seed)`` (a
    frozen stream, so the same numbers from any torch and numpy, on any
    machine), made trainable on ``device``: a run on the card and one on
    the CPU start from the same bits."""
    from repro_torch.models import lm
    from repro_torch.nn.common import (Initializer, ParamTree, trainable,
                                       truncated_normal)

    class HostDraws(Initializer):
        def param(self, shape, axes=None, *, std=None, init=truncated_normal,
                  dtype=None):
            if init is truncated_normal:
                init = _host_truncated_normal
            return super().param(shape, axes, std=std, init=init, dtype=dtype)

    ini = HostDraws(np.random.RandomState(seed), lm._dtype(cfg), device)
    return trainable(ParamTree(lm._init_tree(ini, cfg)))


def param_digest(params) -> str:
    """SHA-256 of a parameter tree's leaves' bytes, in tree order."""
    import hashlib

    from repro_torch.core import tree as tree_lib

    h = hashlib.sha256()
    for leaf in tree_lib.leaves(params):
        h.update(leaf.detach().cpu().contiguous().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def _shard(batch, r: int, P: int, device):
    b = next(iter(batch.values())).shape[0] // P
    return {k: torch.from_numpy(v[r * b:(r + 1) * b]).to(device)
            for k, v in batch.items()}


def compressed_dp_run(arch: str, steps: int, global_batch: int, seq_len: int,
                      lr: float, *, device, smoke: bool = True,
                      n_layers=None, data_seed: int = 17, dtype=None) -> dict:
    """``steps`` compressed-DP train steps of ``arch`` (its smoke config,
    or the full one; ``n_layers`` deep and in ``dtype`` when given) on
    this rank of the default group, on ``device``, from :func:`dp_weights`,
    ``constant_schedule(lr)`` and no weight decay (the JAX package's
    ``test_compressed_dp_training_converges``): each step's global batch of
    the chain data (seed ``data_seed``) split over the ranks in rank order.
    Returns the averaged losses and a digest of the final parameters."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import make_executor
    from repro_torch.data import DataConfig, global_step_batch
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import adamw, constant_schedule

    r, P = _rank()
    device = torch.device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    executor = make_executor("cuda" if device.type == "cuda" else "torch",
                             device=device)
    params = dp_weights(cfg, device)
    opt = adamw(constant_schedule(lr), weight_decay=0.0)
    dcfg = DataConfig(
        vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch,
        seed=data_seed,
        stub_embed_dim=cfg.d_model if cfg.frontend == "stub_embeddings" else 0)
    opt_state = opt.init(params)
    step_fn, init_err = steps_lib.make_compressed_dp_train_step(
        cfg, opt, executor=executor)
    err = init_err(params)
    losses = []
    for step in range(steps):
        batch = _shard(global_step_batch(dcfg, step), r, P, device)
        params, opt_state, err, stats = step_fn(params, opt_state, err, batch)
        losses.append(float(stats["loss"]))
    return {"losses": losses, "digest": param_digest(params)}


_OPS = {"compressed_psum": _compressed_psum, "ring_rs": _ring,
        "ring_ag": _ring, "moe_ep": _moe_ep, "census_step": _census_step}


def run_train_cases(cases: List[dict], device) -> List:
    """Every case on this rank, in order; the results in a list."""
    out = []
    for case in cases:
        if case["op"] == "compressed_dp":
            out.append(compressed_dp_run(
                case["arch"], case["steps"], case["global_batch"],
                case["seq_len"], case["lr"], device=device,
                smoke=case.get("smoke", True), n_layers=case.get("n_layers"),
                data_seed=case.get("data_seed", 17), dtype=case.get("dtype")))
        elif case["op"] in _OPS:
            out.append(_OPS[case["op"]](case, torch.device(device)))
        else:
            raise ValueError(f"unknown case op {case['op']!r}")
    return out
