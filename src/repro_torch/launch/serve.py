"""Serving driver: batched prefill + decode with KV / state caches.

The port of ``repro/launch/serve.py``: random weights (seed 0), a batch of
random prompts from ``--seed``, one prefill that fills the cache, then
``gen_len - 1`` decode steps, greedy (argmax) or sampled at
``--temperature`` (``torch.multinomial`` from a generator seeded with
``--seed``).  A stub-frontend model (musicgen-large, pixtral-12b) is fed
random prompt embeddings (a standard normal from the numpy seed), then the
token embedding of each sampled token.  It runs on the card through the
CUDA executor unless ``--device cpu`` is given, and raises without a
card::

    python -m repro_torch.launch.serve --arch granite-8b            # the card
    python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --batch 8 \\
        --prompt-len 2048 --gen-len 64
    python -m repro_torch.launch.serve --arch minicpm3-4b --smoke \\
        --device cpu --executor torch

This entry point is family-neutral: ``--arch`` takes every configuration
``repro_torch.configs`` carries (all ten of the JAX package's).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import default_device, make_executor
from repro_torch.core.executor import synchronize
from repro_torch.launch import steps as steps_lib
from repro_torch.models import lm
from repro_torch.observability import trace

__all__ = ["ServeResult", "serve", "feed", "main"]


@dataclasses.dataclass
class ServeResult:
    """What one serving run produced: ``tokens`` (B, gen_len), the prefill's
    last-position logits (B, vocab) f32, each decode step's logits, the
    prompt (token ids (B, S), or embeddings (B, S, d) f32 for a stub
    frontend), and the host-clock times of the prefill and of the decode
    loop (each ending in a device synchronize)."""

    tokens: torch.Tensor
    prefill_logits: torch.Tensor
    step_logits: List[torch.Tensor]
    prompt: torch.Tensor
    prefill_s: float
    decode_s: float
    tokens_per_s: float


def _prompt(cfg, batch: int, prompt_len: int, seed: int, device) -> torch.Tensor:
    """The prompt from the numpy seed: token ids, or for a stub frontend
    standard-normal embeddings (f32), as the JAX package's serve.py draws
    them."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "stub_embeddings":
        emb = rng.normal(size=(batch, prompt_len, cfg.d_model)).astype(np.float32)
        return torch.as_tensor(emb, device=device)
    toks = rng.integers(0, cfg.vocab, size=(batch, prompt_len))
    return torch.as_tensor(toks, dtype=torch.int64, device=device)


def feed(cfg, params, prompt=None, tokens=None) -> dict:
    """A step's batch: the prompt (``tokens`` or ``embeds``), or a decode
    step's sampled ``tokens`` (B,) — for a stub frontend their token
    embedding in the model's dtype."""
    stub = cfg.frontend == "stub_embeddings"
    if prompt is not None:
        return {"embeds" if stub else "tokens": prompt}
    if stub:
        return {"embeds": lm.embed(params["embedding"], tokens[:, None])
                .to(lm._dtype(cfg))}
    return {"tokens": tokens[:, None]}


def serve(cfg, *, batch: int, prompt_len: int, gen_len: int, seed: int = 0,
          greedy: bool = True, temperature: float = 1.0, executor=None,
          device=None, params=None) -> ServeResult:
    """Prefill a batch of random prompts, then decode ``gen_len - 1`` steps.

    ``device`` defaults to the card and ``executor`` to the CUDA executor on
    it; ``params`` to :func:`lm.init_model` with seed 0 on the device."""
    dev = torch.device(device) if device is not None else default_device()
    ex = executor if executor is not None else make_executor("cuda", device=dev)
    if ex.kernel_space == "cuda" and dev.type != "cuda":
        raise ValueError("the cuda executor runs on the card; use the torch or "
                         "reference executor with device='cpu'")
    if params is None:
        params = lm.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    s_max = prompt_len + gen_len
    prompt = _prompt(cfg, batch, prompt_len, seed, dev)
    prefill_fn = steps_lib.make_prefill_step(cfg, executor=ex)
    decode_fn = steps_lib.make_decode_step(cfg, executor=ex)
    gen = torch.Generator(dev).manual_seed(seed)

    def sample(logits):
        if greedy:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    with torch.inference_mode():
        cache = lm.init_cache(cfg, batch, s_max, device=dev)
        synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill_fn(params, feed(cfg, params, prompt), cache)
        synchronize()
        t_prefill = time.perf_counter() - t0

        prefill_logits = logits
        tokens = sample(logits)
        generated, step_logits = [tokens], []
        t0 = time.perf_counter()
        for t in range(prompt_len, prompt_len + gen_len - 1):
            logits, cache = decode_fn(params, feed(cfg, params, tokens=tokens),
                                      t, cache)
            tokens = sample(logits)
            generated.append(tokens)
            step_logits.append(logits)
        synchronize()
        t_decode = time.perf_counter() - t0

    out = torch.stack(generated, dim=1)
    tok_s = batch * (gen_len - 1) / max(t_decode, 1e-9)
    print(f"[serve] {cfg.name}: prefill {batch}x{prompt_len} in "
          f"{t_prefill * 1e3:.0f}ms; decode {gen_len - 1} steps at "
          f"{tok_s:.1f} tok/s ({ex.name} on {dev})", flush=True)
    return ServeResult(tokens=out, prefill_logits=prefill_logits,
                       step_logits=step_logits, prompt=prompt,
                       prefill_s=t_prefill, decode_s=t_decode,
                       tokens_per_s=tok_s)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke configuration")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="rng seed for prompts and sampling")
    ap.add_argument("--executor", default="cuda",
                    help="executor kind (cuda | torch | reference) or hardware "
                         "target")
    ap.add_argument("--device", default=None,
                    help="device of the run (default: the card; 'cpu' asks for "
                         "the CPU with --executor torch|reference)")
    trace.add_cli_flag(ap)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    trace.enable_from_args(args)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = torch.device(args.device) if args.device else default_device()
    ex = make_executor(args.executor, device=device)
    if ex.kernel_space == "cuda" and device.type != "cuda":
        ap.error("the cuda executor runs on the card; use --executor "
                 "torch|reference with --device cpu")
    serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
          gen_len=args.gen_len, seed=args.seed,
          greedy=args.temperature == 0.0,
          temperature=max(args.temperature, 1e-3), executor=ex, device=device)
    if args.trace and trace.export(args.trace):
        print(f"trace -> {args.trace}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
