"""Training entry point: data -> train step -> checkpoints, fault-tolerant.  The
port of ``repro/launch/train.py``.

Runs on the card through the CUDA executor unless ``--device cpu`` is given
(then the torch executor), and raises without a card.  Wiring:

* deterministic resumable data (:mod:`repro_torch.data`, seed 17);
* the train step (:func:`repro_torch.launch.steps.make_train_step`):
  ``lm.loss_fn``'s gradients through the kernels, AdamW with the JAX
  ``train()``'s warmup-cosine schedule (peak 3e-3, a tenth of the steps of
  warmup, weight decay 0.01);
* async atomic checkpoints and exact resume (step, data state)
  (:mod:`repro_torch.checkpoint`), restored onto any device;
* preemption checkpoint-and-exit and the straggler monitor
  (:mod:`repro_torch.runtime`).

``train_deq`` trains the deep-equilibrium model (a batched GMRES solve a
forward, an adjoint solve a backward) and prints ``DEQ-GATE: PASS`` when
its loss fell.

Usage::

    python -m repro_torch.launch.train --arch smollm-135m --smoke --steps 60 \\
        --device cpu
    python -m repro_torch.launch.train --arch smollm-135m --global-batch 8 \\
        --seq-len 2048 --steps 40                      # full width, the card
    python -m repro_torch.launch.train --model deq --smoke --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import default_device, make_executor
from repro_torch.core.executor import synchronize
from repro_torch.data import DataConfig, DataIterator, entropy_floor
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_host_mesh, use_mesh
from repro_torch.models import lm
from repro_torch.nn.common import trainable
from repro_torch.observability import trace
from repro_torch.optim import adamw, warmup_cosine_schedule
from repro_torch.runtime import PreemptionHandler, StragglerMonitor

__all__ = ["build_state", "train", "train_deq", "main"]


def _placement(device):
    """(device, executor): the card and the CUDA executor unless ``device``
    names the CPU (then the torch executor)."""
    device = torch.device(device) if device is not None else default_device()
    return device, make_executor("cuda" if device.type == "cuda" else "torch",
                                 device=device)


def _to_device(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def build_state(cfg, opt, mesh, ckpt: Optional[CheckpointManager], data_cfg,
                *, device, init_params=None):
    """Init or restore (params, opt_state, data_iter, start_step); the
    parameters trainable, on ``device``."""
    del mesh  # one process holds the whole model: nothing to place
    data_iter = DataIterator(data_cfg)
    if ckpt is not None and ckpt.latest_step() is not None:
        shapes = lm.init_model(cfg, device="meta")
        target = {"params": shapes, "opt": opt.init(shapes)}
        tree, meta = ckpt.restore(target=target, device=device)
        data_iter.restore(meta["data"])
        print(f"[train] restored step {meta['step']} from {ckpt.directory}")
        return (trainable(tree["params"]), tree["opt"], data_iter,
                int(meta["step"]))
    params = (init_params if init_params is not None
              else lm.init_model(cfg, device=device))
    params = trainable(params)
    return params, opt.init(params), data_iter, 0


def train(
    cfg,
    *,
    steps: int,
    global_batch: int,
    seq_len: int,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 20,
    resume: bool = False,
    data_shards: int = 1,
    mesh=None,
    log_every: int = 10,
    preemption: Optional[PreemptionHandler] = None,
    stop_at_step: Optional[int] = None,  # simulate an interruption (tests)
    init_params=None,
    device=None,
):
    """Train ``cfg`` for ``steps`` steps; returns (params, losses).

    ``init_params`` starts from given weights (a parameter tree on
    ``device``) in place of ``lm.init_model``'s seed-0 draw.  ``device`` is
    the card unless given: the CUDA executor runs there, the torch one on
    the CPU."""
    device, executor = _placement(device)
    mesh = mesh or make_host_mesh(1, 1)
    opt = adamw(warmup_cosine_schedule(3e-3, max(steps // 10, 1), steps),
                weight_decay=0.01)
    data_cfg = DataConfig(
        vocab=cfg.vocab,
        seq_len=seq_len,
        global_batch=global_batch,
        num_shards=data_shards,
        seed=17,
        stub_embed_dim=cfg.d_model if cfg.frontend == "stub_embeddings" else 0,
    )
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if not resume and ckpt is not None and ckpt.latest_step() is not None:
        raise SystemExit(
            f"{ckpt_dir} already has checkpoints; pass --resume to continue")

    params, opt_state, data_iter, start = build_state(
        cfg, opt, mesh, ckpt, data_cfg, device=device, init_params=init_params)
    step_fn = steps_lib.make_train_step(cfg, opt, executor=executor)
    monitor = StragglerMonitor(window=50, factor=4.0)

    losses: List[float] = []
    t_start = time.perf_counter()
    with use_mesh(mesh):
        for step in range(start, steps):
            batch = _to_device(next(data_iter), device)
            monitor.start_step()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            synchronize()
            if monitor.end_step():
                print(f"[train] step {step}: straggler alarm "
                      f"(median {monitor.median*1e3:.0f}ms)")
            losses.append(float(metrics["loss"]))
            if step % log_every == 0 or step == steps - 1:
                print(
                    f"[train] step {step:5d} loss {float(metrics['loss']):.4f} "
                    f"lr {float(metrics['lr']):.2e} gnorm "
                    f"{float(metrics['grad_norm']):.2f}"
                )
            want_ckpt = ckpt is not None and (
                (step + 1) % ckpt_every == 0 or step == steps - 1)
            if preemption is not None and preemption.preempted:
                if ckpt is not None:
                    ckpt.save(step + 1, {"params": params, "opt": opt_state},
                              metadata={"step": step + 1,
                                        "data": data_iter.state()},
                              block=True)
                    print(f"[train] preempted — checkpointed step {step+1}, "
                          "exiting")
                return params, losses
            if want_ckpt:
                ckpt.save(step + 1, {"params": params, "opt": opt_state},
                          metadata={"step": step + 1, "data": data_iter.state()})
            if stop_at_step is not None and step + 1 >= stop_at_step:
                if ckpt is not None:
                    ckpt.wait()
                print(f"[train] stopped at step {step + 1} (requested)")
                return params, losses
    if ckpt is not None:
        ckpt.wait()
    dt = time.perf_counter() - t_start
    tok_s = (steps - start) * global_batch * seq_len / max(dt, 1e-9)
    if losses:
        print(f"[train] done: {steps - start} steps in {dt:.1f}s ({tok_s:.0f} "
              f"tok/s); final loss {losses[-1]:.4f} (entropy floor "
              f"{entropy_floor(data_cfg):.4f})")
    return params, losses


def train_deq(*, steps: int, batch: int, lr: float = 3e-2, log_every: int = 5,
              device=None) -> bool:
    """Train the deep-equilibrium regression model end to end: every
    forward a batched GMRES solve, every backward an adjoint solve.
    Returns True when the loss fell from the first step to the last (the
    DEQ-GATE criterion)."""
    from repro_torch.models import deq as deq_lib
    from repro_torch.optim import constant_schedule

    device, executor = _placement(device)
    cfg = deq_lib.DeqConfig(device=device, executor=executor)
    params = deq_lib.init_deq(torch.Generator().manual_seed(0), cfg)
    for p in params.values():
        p.requires_grad_(True)
    opt = adamw(constant_schedule(lr), weight_decay=0.0, clip_norm=None)
    opt_state = opt.init(params)
    batch_data = deq_lib.synthetic_batch(0, batch, cfg)

    losses = []
    for step in range(steps):
        loss = deq_lib.deq_loss(params, batch_data, cfg)
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = dict(zip(params, grads))
        params, opt_state, _ = opt.update(params, grads, opt_state)
        losses.append(float(loss.detach()))
        if step % log_every == 0 or step == steps - 1:
            print(f"[deq] step {step:4d} loss {losses[-1]:.6f}")
    decreased = losses[-1] < losses[0]
    print(f"DEQ-GATE: {'PASS' if decreased else 'FAIL'} "
          f"(loss {losses[0]:.6f} -> {losses[-1]:.6f})")
    return decreased


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--model", default="lm", choices=["lm", "deq"])
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    trace.add_cli_flag(ap)
    args = ap.parse_args(argv)
    trace.enable_from_args(args)
    device = torch.device(args.device) if args.device else default_device()

    if args.model == "deq":
        steps = min(args.steps, 30) if args.smoke else args.steps
        ok = train_deq(steps=steps, batch=args.global_batch, device=device)
        raise SystemExit(0 if ok else 1)

    if args.arch is None:
        ap.error("--arch is required for --model lm")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    handler = PreemptionHandler().install()
    train(
        cfg,
        steps=args.steps,
        global_batch=args.global_batch,
        seq_len=args.seq_len,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        resume=args.resume,
        preemption=handler,
        device=device,
    )
    if args.trace and trace.export(args.trace):
        print(f"trace -> {args.trace}")


if __name__ == "__main__":
    main()
