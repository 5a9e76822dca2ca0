"""Language models: the port of ``repro/models/lm.py`` for the hybrid and
RWKV6 families.

One contract, as in the JAX package:

* ``init_model(cfg, generator, device) -> params``  (a :class:`ParamTree`)
* ``forward(params, cfg, tokens) -> (logits, metrics)``
* ``init_cache(cfg, batch, s_max, device) -> cache``
* ``prefill(params, cfg, tokens, cache) -> (logits, cache)``
* ``decode_step(params, cfg, tokens, length, cache) -> (logits, cache)``

The hybrid family is Zamba2: groups of Mamba2 layers, each group followed by
a shared attention + MLP block at width 2 d over concat(hidden, original
embedding), with per-group LoRA deltas on the shared q/k/v.  The RWKV6
family is Finch: a layernorm on the embedding (``ln0``), then blocks of
layernorm, time-mix (the WKV scan), layernorm, channel-mix, and a layernorm
before the head.  The JAX package's ``lax.scan`` over stacked layers is a
Python loop over ``nn.ModuleList``s here (``params["mamba"][g][i]``,
``params["lora"][g]``, ``params["blocks"][i]``).  Every hot op dispatches
through the registry (``nn_rmsnorm``, ``nn_attention``, ``nn_ssd_scan``,
``nn_rwkv6_scan``), so the same model runs on the reference, torch and cuda
executors.

The cache keeps the JAX package's stacked layout (``(G, per, B, ...)`` for
the Mamba state, ``(G, B, Hkv, Smax, D)`` for the KV cache, ``(n_layers, B,
H, K, V)`` f32 for the WKV state and ``(n_layers, B, d)`` for the token
shifts); ``prefill`` and ``decode_step`` write it in place and return it.

The transformer (dense / MLA / MoE) families, the stub-embedding frontend
and sinusoidal positions, and the loss (training) are not ported yet
(ROADMAP A15); asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.executor import default_device
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import mamba as mamba_lib
from repro_torch.nn import rwkv as rwkv_lib
from repro_torch.nn.attention import KVCache
from repro_torch.nn.common import Initializer, ParamTree
from repro_torch.nn.layers import (
    embed,
    embedding_init,
    layernorm,
    layernorm_init,
    rmsnorm,
    rmsnorm_init,
    swiglu,
    swiglu_init,
    unembed,
)
from repro_torch.nn.mamba import MambaState
from repro_torch.nn.rwkv import RWKVState

__all__ = ["init_model", "forward", "init_cache", "prefill", "decode_step"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


#: the families the port runs, each with the norm its configuration uses
_PORTED_NORMS = {"hybrid": "rmsnorm", "rwkv6": "layernorm"}


def _require_ported(cfg) -> None:
    if cfg.family not in _PORTED_NORMS:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to "
            "repro_torch yet (ROADMAP A15); the hybrid and rwkv6 families are")
    if cfg.frontend != "tokens" or cfg.pos_kind != "rope":
        raise NotImplementedError(
            f"{cfg.name}: frontend {cfg.frontend!r} / positions "
            f"{cfg.pos_kind!r} are not ported yet (ROADMAP A15)")
    if cfg.norm_kind != _PORTED_NORMS[cfg.family]:
        raise NotImplementedError(f"{cfg.name}: norm {cfg.norm_kind!r} is not "
                                  f"ported yet for the {cfg.family!r} family "
                                  "(ROADMAP A15)")


def _norm(p, x, cfg, executor=None):
    if cfg.norm_kind == "layernorm":
        return layernorm(p, x, cfg.norm_eps)
    return rmsnorm(p, x, cfg.norm_eps, executor=executor)


# =============================================================================
# rwkv6 family
# =============================================================================


def _rwkv_block_init(ini: Initializer, cfg) -> dict:
    return {
        "ln1": layernorm_init(ini, cfg.d_model),
        "time_mix": rwkv_lib.time_mix_init(ini, cfg),
        "ln2": layernorm_init(ini, cfg.d_model),
        "channel_mix": rwkv_lib.channel_mix_init(ini, cfg),
    }


def _rwkv_block_forward(bp, x, cfg, state=None, executor=None):
    h = layernorm(bp["ln1"], x, cfg.norm_eps)
    a, state = rwkv_lib.time_mix_forward(bp["time_mix"], h, cfg, state,
                                         executor=executor)
    x = x + a
    h = layernorm(bp["ln2"], x, cfg.norm_eps)
    c, state = rwkv_lib.channel_mix_forward(bp["channel_mix"], h, cfg, state)
    return x + c, state


def _rwkv_block_step(bp, x, cfg, state):
    h = layernorm(bp["ln1"], x, cfg.norm_eps)
    a, state = rwkv_lib.time_mix_step(bp["time_mix"], h, cfg, state)
    x = x + a
    h = layernorm(bp["ln2"], x, cfg.norm_eps)
    c, state = rwkv_lib.channel_mix_forward(bp["channel_mix"], h, cfg, state)
    return x + c, state


# =============================================================================
# hybrid family (zamba2: mamba2 backbone + shared attention block)
# =============================================================================


def _shared_cfg(cfg):
    """The shared transformer block operates at width 2 * d_model."""
    return dataclasses.replace(
        cfg,
        family="dense",
        d_model=2 * cfg.d_model,
        head_dim=2 * cfg.d_model // cfg.n_heads,
        d_ff=cfg.d_ff,
    )


def _zamba_shared_init(ini: Initializer, cfg) -> dict:
    scfg = _shared_cfg(cfg)
    return {
        "norm1": rmsnorm_init(ini, scfg.d_model),
        "attn": attn_lib.gqa_init(ini, scfg),
        "norm2": rmsnorm_init(ini, scfg.d_model),
        "mlp": swiglu_init(ini, scfg.d_model, scfg.d_ff),
        "out_proj": ini.param((scfg.d_model, cfg.d_model),
                              std=scfg.d_model ** -0.5),
    }


def _zamba_lora_init(ini: Initializer, cfg) -> dict:
    """Per-invocation LoRA deltas on the shared q/k/v projections."""
    scfg = _shared_cfg(cfg)
    d2 = scfg.d_model
    H, hd = scfg.n_heads, scfg.resolved_head_dim
    r = cfg.lora_rank
    p = {}
    for name in ("q", "k", "v"):
        p[f"{name}_a"] = ini.param((d2, r), std=d2 ** -0.5)
        p[f"{name}_b"] = ini.param((r, H * hd), std=1e-4)
    return p


def _zamba_shared_forward(sp, lp, x2, cfg, positions, cache=None, length=None,
                          mode="forward", executor=None):
    """Shared block with per-invocation LoRA on x2 (B, S, 2d).  The deltas
    are materialised as W + A @ B for each invocation, as in the JAX
    package."""
    scfg = _shared_cfg(cfg)
    ap = dict(sp["attn"].items())
    for name, key in (("q", "wq"), ("k", "wk"), ("v", "wv")):
        ap[key] = sp["attn"][key] + lp[f"{name}_a"] @ lp[f"{name}_b"]
    h = _norm(sp["norm1"], x2, scfg, executor)
    if mode == "forward":
        a = attn_lib.gqa_forward(ap, h, scfg, positions, executor=executor)
    elif mode == "prefill":
        a, cache = attn_lib.gqa_prefill(ap, h, scfg, positions, cache,
                                        executor=executor)
    else:
        a, cache = attn_lib.gqa_decode(ap, h, scfg, length, cache,
                                       executor=executor)
    x2 = x2 + a
    h = _norm(sp["norm2"], x2, scfg, executor)
    x2 = x2 + swiglu(sp["mlp"], h)
    return x2 @ sp["out_proj"], cache


def _zamba_groups(cfg) -> Tuple[int, int]:
    every = cfg.shared_attn_every
    if cfg.n_layers % every:
        raise ValueError(f"zamba: n_layers {cfg.n_layers} not a multiple of "
                         f"shared_attn_every {every}")
    return cfg.n_layers // every, every


# =============================================================================
# model init
# =============================================================================


def init_model(cfg, generator: Optional[torch.Generator] = None,
               device=None) -> ParamTree:
    """Random parameters with the JAX package's distributions (each std and
    init rule of ``ParamBuilder.param``), drawn on ``device`` (the card
    unless asked otherwise) from ``generator`` (a fresh one seeded 0 when
    None).  ``device="meta"`` gives shapes and dtypes without storage."""
    _require_ported(cfg)
    dev = torch.device(device) if device is not None else default_device()
    if generator is None and dev.type != "meta":
        generator = torch.Generator(dev).manual_seed(0)
    ini = Initializer(generator, _dtype(cfg), dev)
    params: Dict[str, Any] = {
        "embedding": embedding_init(ini, cfg.vocab, cfg.d_model)}
    if cfg.family == "rwkv6":
        params["ln0"] = layernorm_init(ini, cfg.d_model)  # rwkv normalises the embedding
        params["blocks"] = [_rwkv_block_init(ini, cfg)
                            for _ in range(cfg.n_layers)]
        params["final_norm"] = layernorm_init(ini, cfg.d_model)
    else:
        G, per = _zamba_groups(cfg)
        params["mamba"] = [[mamba_lib.mamba_init(ini, cfg) for _ in range(per)]
                           for _ in range(G)]
        params["shared"] = _zamba_shared_init(ini, cfg)
        params["lora"] = [_zamba_lora_init(ini, cfg) for _ in range(G)]
        params["final_norm"] = rmsnorm_init(ini, cfg.d_model)
    if not cfg.tie_embeddings:
        params["lm_head"] = ini.param((cfg.d_model, cfg.vocab),
                                      std=cfg.d_model ** -0.5)
    return ParamTree(params)


# =============================================================================
# forward
# =============================================================================


def _positions(B: int, S: int, start: int, device) -> torch.Tensor:
    pos = torch.arange(start, start + S, dtype=torch.int32, device=device)
    return pos.expand(B, S)


def _inputs_to_h(params, cfg, tokens):
    if tokens is None:
        raise ValueError(f"{cfg.name}: the token frontend needs `tokens`")
    return embed(params["embedding"], tokens) * cfg.emb_scale


def _head(params, cfg, h, executor=None):
    h = _norm(params["final_norm"], h, cfg, executor)
    if cfg.tie_embeddings:
        logits = unembed(params["embedding"], h)
    else:
        logits = h @ params["lm_head"]
    return logits.to(torch.float32) * cfg.logit_scale


def forward(params, cfg, tokens: torch.Tensor, embeds=None, *,
            executor=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Logits (B, S, vocab) f32 of a whole causal pass; no cache."""
    _require_ported(cfg)
    if embeds is not None:
        raise NotImplementedError("the stub-embedding frontend is not ported "
                                  "yet (ROADMAP A15)")
    B, S = tokens.shape
    h = _inputs_to_h(params, cfg, tokens)
    if cfg.family == "rwkv6":
        h = layernorm(params["ln0"], h, cfg.norm_eps)
        for bp in params["blocks"]:
            h, _ = _rwkv_block_forward(bp, h, cfg, executor=executor)
        return _head(params, cfg, h, executor), {}
    positions = _positions(B, S, 0, tokens.device)
    emb0 = h
    G, per = _zamba_groups(cfg)
    for g in range(G):
        for i in range(per):
            y, _ = mamba_lib.mamba_forward(params["mamba"][g][i], h, cfg,
                                           executor=executor)
            h = h + y
        x2 = torch.cat([h, emb0], dim=-1)
        delta, _ = _zamba_shared_forward(params["shared"], params["lora"][g],
                                         x2, cfg, positions, executor=executor)
        h = h + delta
    return _head(params, cfg, h, executor), {}


# =============================================================================
# caches / serving
# =============================================================================


def init_cache(cfg, batch: int, s_max: int, device=None):
    """The zeroed cache on ``device`` (the card unless asked otherwise):
    for the hybrid family the Mamba state ``(G, per, B, ...)`` and KV cache
    ``(G, B, Hkv, s_max, D)``; for RWKV6 an :class:`RWKVState` of WKV states
    ``(n_layers, B, H, K, V)`` f32 and token shifts ``(n_layers, B, d)``
    (no position axis: ``s_max`` is not used)."""
    _require_ported(cfg)
    dev = torch.device(device) if device is not None else default_device()
    dt = _dtype(cfg)
    if cfg.family == "rwkv6":
        H, K = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        shift = (cfg.n_layers, batch, cfg.d_model)
        return RWKVState(
            wkv=torch.zeros((cfg.n_layers, batch, H, K, K),
                            dtype=torch.float32, device=dev),
            shift_tm=torch.zeros(shift, dtype=dt, device=dev),
            shift_cm=torch.zeros(shift, dtype=dt, device=dev),
        )
    G, per = _zamba_groups(cfg)
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    scfg = _shared_cfg(cfg)
    hd2 = scfg.resolved_head_dim
    kv_shape = (G, batch, scfg.n_kv_heads, s_max, hd2)
    return {
        "mamba": MambaState(
            conv=torch.zeros((G, per, batch, cfg.ssm_conv - 1, conv_dim),
                             dtype=dt, device=dev),
            ssm=torch.zeros((G, per, batch, H, cfg.ssm_state, cfg.ssm_head_dim),
                            dtype=torch.float32, device=dev),
        ),
        "kv": KVCache(k=torch.zeros(kv_shape, dtype=dt, device=dev),
                      v=torch.zeros(kv_shape, dtype=dt, device=dev)),
    }


def _layer_state(cache, g: int, i: int) -> MambaState:
    return MambaState(conv=cache["mamba"].conv[g, i], ssm=cache["mamba"].ssm[g, i])


def _store_state(cache, g: int, i: int, st: MambaState) -> None:
    cache["mamba"].conv[g, i].copy_(st.conv)
    cache["mamba"].ssm[g, i].copy_(st.ssm)


def _group_kv(cache, g: int) -> KVCache:
    return KVCache(k=cache["kv"].k[g], v=cache["kv"].v[g])


def _rwkv_layer(cache: RWKVState, i: int) -> RWKVState:
    return RWKVState(wkv=cache.wkv[i], shift_tm=cache.shift_tm[i],
                     shift_cm=cache.shift_cm[i])


def _rwkv_store(cache: RWKVState, i: int, st: RWKVState) -> None:
    cache.wkv[i].copy_(st.wkv)
    cache.shift_tm[i].copy_(st.shift_tm)
    cache.shift_cm[i].copy_(st.shift_cm)


def prefill(params, cfg, tokens: torch.Tensor = None, embeds=None, cache=None,
            *, executor=None):
    """Process a prompt, fill the cache at offset 0 (in place), return the
    logits (B, S, vocab) f32 and the cache."""
    _require_ported(cfg)
    if embeds is not None:
        raise NotImplementedError("the stub-embedding frontend is not ported "
                                  "yet (ROADMAP A15)")
    B, S = tokens.shape
    h = _inputs_to_h(params, cfg, tokens)
    if cfg.family == "rwkv6":
        # the WKV scan starts from zero, whatever the cache holds (C5)
        h = layernorm(params["ln0"], h, cfg.norm_eps)
        for i, bp in enumerate(params["blocks"]):
            h, st = _rwkv_block_forward(bp, h, cfg, _rwkv_layer(cache, i),
                                        executor=executor)
            _rwkv_store(cache, i, st)
        return _head(params, cfg, h, executor), cache
    positions = _positions(B, S, 0, tokens.device)
    emb0 = h
    G, per = _zamba_groups(cfg)
    for g in range(G):
        for i in range(per):
            y, st = mamba_lib.mamba_forward(params["mamba"][g][i], h, cfg,
                                            _layer_state(cache, g, i),
                                            executor=executor)
            _store_state(cache, g, i, st)
            h = h + y
        x2 = torch.cat([h, emb0], dim=-1)
        delta, _ = _zamba_shared_forward(
            params["shared"], params["lora"][g], x2, cfg, positions,
            _group_kv(cache, g), mode="prefill", executor=executor)
        h = h + delta
    return _head(params, cfg, h, executor), cache


def decode_step(params, cfg, tokens: torch.Tensor = None, embeds=None,
                length: int = None, cache=None, *, executor=None):
    """One-token step of tokens (B, 1); ``length`` = tokens already in the
    cache.  Updates the cache in place; returns logits (B, 1, vocab) f32 and
    the cache."""
    _require_ported(cfg)
    if embeds is not None:
        raise NotImplementedError("the stub-embedding frontend is not ported "
                                  "yet (ROADMAP A15)")
    length = int(length)
    B = tokens.shape[0]
    h = _inputs_to_h(params, cfg, tokens)
    if cfg.family == "rwkv6":
        h = layernorm(params["ln0"], h, cfg.norm_eps)
        for i, bp in enumerate(params["blocks"]):
            h, st = _rwkv_block_step(bp, h, cfg, _rwkv_layer(cache, i))
            _rwkv_store(cache, i, st)
        return _head(params, cfg, h, executor), cache
    positions = _positions(B, 1, length, tokens.device)
    emb0 = h
    G, per = _zamba_groups(cfg)
    for g in range(G):
        for i in range(per):
            y, st = mamba_lib.mamba_step(params["mamba"][g][i], h, cfg,
                                         _layer_state(cache, g, i))
            _store_state(cache, g, i, st)
            h = h + y
        x2 = torch.cat([h, emb0], dim=-1)
        delta, _ = _zamba_shared_forward(
            params["shared"], params["lora"][g], x2, cfg, positions,
            _group_kv(cache, g), length=length, mode="decode",
            executor=executor)
        h = h + delta
    return _head(params, cfg, h, executor), cache
