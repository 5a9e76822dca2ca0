"""Language models: the port of ``repro/models/lm.py`` for every family.

One contract, as in the JAX package:

* ``init_model(cfg, generator, device) -> params``  (a :class:`ParamTree`)
* ``forward(params, cfg, tokens | embeds) -> (logits, metrics)``
* ``init_cache(cfg, batch, s_max, device) -> cache``
* ``prefill(params, cfg, tokens | embeds, cache) -> (logits, cache)``
* ``decode_step(params, cfg, tokens | embeds, length, cache) -> (logits, cache)``

The transformer families (``dense``, ``moe``, ``mla``): blocks of norm,
attention (GQA, or MLA's latent attention), norm, and an MLP (SwiGLU, GELU
for musicgen, or the MoE layer), each residual branch scaled by
``residual_scale`` (MiniCPM3).  A stub-embedding frontend (musicgen,
pixtral) takes precomputed ``embeds`` (B, S, d_model) in place of tokens;
sinusoidal positions (musicgen) are added to the input.  The hybrid family
is Zamba2: groups of Mamba2 layers, each group followed by a shared
attention + MLP block at width 2 d over concat(hidden, original embedding),
with per-group LoRA deltas on the shared q/k/v.  The RWKV6 family is
Finch: a layernorm on the embedding (``ln0``), then blocks of layernorm,
time-mix (the WKV scan), layernorm, channel-mix, and a layernorm before the
head.

The JAX package's ``lax.scan`` over stacked layers is a Python loop over
``nn.ModuleList``s here (``params["blocks"][i]``, ``params["mamba"][g][i]``,
``params["lora"][g]``).  Every hot op dispatches through the registry
(``nn_rmsnorm``, ``nn_attention``, ``nn_ssd_scan``, ``nn_rwkv6_scan``), so
the same model runs on the reference, torch and cuda executors.

The cache keeps the JAX package's stacked layout: ``(n_layers, B, Hkv,
Smax, D)`` k and v for the dense and MoE families, ``(n_layers, B, Smax,
kv_lora_rank)`` and ``(n_layers, B, Smax, qk_rope_head_dim)`` latents for
MLA, ``(G, per, B, ...)`` Mamba states and a ``(G, B, Hkv, Smax, D)`` KV
cache for the hybrid family, ``(n_layers, B, H, K, V)`` f32 WKV states and
``(n_layers, B, d)`` token shifts for RWKV6; ``prefill`` and
``decode_step`` write it in place and return it.

Training: ``loss_fn(params, cfg, batch) -> (loss, metrics)`` is the JAX
package's loss; ``model_axes`` and ``cache_axes`` the logical axes the
sharding rules read; ``cfg.remat`` checkpoints each block (each Zamba2
group) as ``_maybe_remat`` says.  Gradients reach every parameter through
the kernels (``repro_torch.kernels._autograd``) once the tree is
:func:`~repro_torch.nn.common.trainable`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.executor import default_device
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import mamba as mamba_lib
from repro_torch.nn import moe as moe_lib
from repro_torch.nn import rwkv as rwkv_lib
from repro_torch.nn.attention import KVCache, MLACache
from repro_torch.nn.common import AxesRecorder, Initializer, ParamTree
from repro_torch.nn.layers import (
    embed,
    embedding_init,
    gelu_mlp,
    gelu_mlp_init,
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

__all__ = ["init_model", "model_axes", "forward", "loss_fn", "init_cache",
           "cache_axes", "prefill", "decode_step", "embed"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


_TRANSFORMER = ("dense", "mla", "moe")
_FAMILIES = _TRANSFORMER + ("rwkv6", "hybrid")


def _check_family(cfg) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


def _norm_init(ini: Initializer, cfg, d=None) -> dict:
    d = d or cfg.d_model
    if cfg.norm_kind == "layernorm":
        return layernorm_init(ini, d)
    return rmsnorm_init(ini, d)


def _norm(p, x, cfg, executor=None):
    if cfg.norm_kind == "layernorm":
        return layernorm(p, x, cfg.norm_eps)
    return rmsnorm(p, x, cfg.norm_eps, executor=executor)


def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(B, S) -> (B, S, d) standard transformer sinusoidal embedding, in
    f32 (the frequencies' exponent step rounded to f32, as in the JAX
    package)."""
    half = d // 2
    dev = positions.device
    step = torch.log(torch.tensor(10000.0, dtype=torch.float32, device=dev)) / half
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=dev) * step)
    ang = positions[..., None].to(torch.float32) * freqs
    out = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if d % 2:
        out = F.pad(out, (0, 1))
    return out


# =============================================================================
# transformer family (dense / mla / moe)
# =============================================================================


def _tf_block_init(ini: Initializer, cfg) -> dict:
    p = {"norm1": _norm_init(ini, cfg)}
    p["attn"] = (attn_lib.mla_init(ini, cfg) if cfg.family == "mla"
                 else attn_lib.gqa_init(ini, cfg))
    p["norm2"] = _norm_init(ini, cfg)
    if cfg.family == "moe":
        p["moe"] = moe_lib.moe_init(ini, cfg)
    elif cfg.mlp_kind == "gelu":
        p["mlp"] = gelu_mlp_init(ini, cfg.d_model, cfg.d_ff)
    else:
        p["mlp"] = swiglu_init(ini, cfg.d_model, cfg.d_ff)
    return p


def _tf_mlp(bp, h, cfg):
    """The block's MLP branch and its metrics (MoE's router losses)."""
    if cfg.family == "moe":
        return moe_lib.moe_forward(bp["moe"], h, cfg)
    if cfg.mlp_kind == "gelu":
        return gelu_mlp(bp["mlp"], h), {}
    return swiglu(bp["mlp"], h), {}


def _tf_block(bp, x, cfg, *, positions=None, cache=None, length=None,
              mode="forward", executor=None):
    """One transformer block in ``mode`` forward | prefill | decode:
    (x, cache, metrics)."""
    rs = cfg.residual_scale
    h = _norm(bp["norm1"], x, cfg, executor)
    if cfg.family == "mla":
        fwd, pre, dec = attn_lib.mla_forward, attn_lib.mla_prefill, attn_lib.mla_decode
    else:
        fwd, pre, dec = attn_lib.gqa_forward, attn_lib.gqa_prefill, attn_lib.gqa_decode
    if mode == "forward":
        a = fwd(bp["attn"], h, cfg, positions, executor=executor)
    elif mode == "prefill":
        a, cache = pre(bp["attn"], h, cfg, positions, cache, executor=executor)
    else:
        a, cache = dec(bp["attn"], h, cfg, length, cache, executor=executor)
    x = x + rs * a
    h = _norm(bp["norm2"], x, cfg, executor)
    m, metrics = _tf_mlp(bp, h, cfg)
    return x + rs * m, cache, metrics


def _tf_layer_cache(cache, i: int):
    """Layer ``i``'s view of the stacked cache (writes land in the stack)."""
    if isinstance(cache, MLACache):
        return MLACache(c_kv=cache.c_kv[i], k_rope=cache.k_rope[i])
    return KVCache(k=cache.k[i], v=cache.v[i])


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
        "out_proj": ini.param((scfg.d_model, cfg.d_model), ("mlp", "embed"),
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
        p[f"{name}_a"] = ini.param((d2, r), ("embed", None), std=d2 ** -0.5)
        p[f"{name}_b"] = ini.param((r, H * hd), (None, "heads"), std=1e-4)
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
    _check_family(cfg)
    dev = torch.device(device) if device is not None else default_device()
    if generator is None and dev.type != "meta":
        generator = torch.Generator(dev).manual_seed(0)
    return ParamTree(_init_tree(Initializer(generator, _dtype(cfg), dev), cfg))


def model_axes(cfg) -> Dict[str, Any]:
    """The logical axes of every leaf of :func:`init_model`'s tree (a tuple
    such as ``("embed", "mlp")``, or None), in nested dicts and per-layer
    lists: the JAX package's ``axes`` tree without the stacked layer axis."""
    _check_family(cfg)
    return _init_tree(AxesRecorder(_dtype(cfg)), cfg)


def _init_tree(ini: Initializer, cfg) -> Dict[str, Any]:
    params: Dict[str, Any] = {
        "embedding": embedding_init(ini, cfg.vocab, cfg.d_model)}
    if cfg.family in _TRANSFORMER:
        params["blocks"] = [_tf_block_init(ini, cfg)
                            for _ in range(cfg.n_layers)]
    elif cfg.family == "rwkv6":
        params["ln0"] = layernorm_init(ini, cfg.d_model)  # rwkv normalises the embedding
        params["blocks"] = [_rwkv_block_init(ini, cfg)
                            for _ in range(cfg.n_layers)]
    else:
        G, per = _zamba_groups(cfg)
        params["mamba"] = [[mamba_lib.mamba_init(ini, cfg) for _ in range(per)]
                           for _ in range(G)]
        params["shared"] = _zamba_shared_init(ini, cfg)
        params["lora"] = [_zamba_lora_init(ini, cfg) for _ in range(G)]
    params["final_norm"] = _norm_init(ini, cfg)
    if not cfg.tie_embeddings:
        params["lm_head"] = ini.param((cfg.d_model, cfg.vocab),
                                      ("embed", "vocab"),
                                      std=cfg.d_model ** -0.5)
    return params


# =============================================================================
# forward
# =============================================================================


def _positions(B: int, S: int, start: int, device) -> torch.Tensor:
    pos = torch.arange(start, start + S, dtype=torch.int32, device=device)
    return pos.expand(B, S)


def _batch_len(tokens, embeds) -> Tuple[int, int]:
    return tuple(tokens.shape) if tokens is not None else tuple(embeds.shape[:2])


def _inputs_to_h(params, cfg, tokens, embeds, positions):
    """The input stream: the token embedding (times ``emb_scale``), or the
    stub frontend's ``embeds`` in the model's dtype; plus sinusoidal
    positions where the configuration uses them."""
    if cfg.frontend == "stub_embeddings":
        if embeds is None:
            raise ValueError(f"{cfg.name}: stub-frontend model needs `embeds`")
        h = embeds.to(_dtype(cfg))
    else:
        if tokens is None:
            raise ValueError(f"{cfg.name}: the token frontend needs `tokens`")
        h = embed(params["embedding"], tokens) * cfg.emb_scale
    if cfg.pos_kind == "sinusoidal":
        h = h + _sinusoidal(positions, cfg.d_model).to(h.dtype)
    return h


def _head(params, cfg, h, executor=None):
    h = _norm(params["final_norm"], h, cfg, executor)
    if cfg.tie_embeddings:
        logits = unembed(params["embedding"], h)
    else:
        logits = h @ params["lm_head"]
    # in place: a prefill's (B, S, vocab) f32 logits are held once
    return logits.to(torch.float32).mul_(cfg.logit_scale)


def forward(params, cfg, tokens: torch.Tensor = None, embeds=None, *,
            executor=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Logits (B, S, vocab) f32 of a whole causal pass, no cache; the
    metrics are the MoE family's router losses summed over the layers."""
    _check_family(cfg)
    B, S = _batch_len(tokens, embeds)
    dev = (tokens if tokens is not None else embeds).device
    positions = _positions(B, S, 0, dev)
    h = _inputs_to_h(params, cfg, tokens, embeds, positions)
    metrics: Dict[str, torch.Tensor] = {}
    if cfg.family in _TRANSFORMER:
        def block(x, bp):
            x, _, m = _tf_block(bp, x, cfg, positions=positions,
                                executor=executor)
            return x, m

        block = _maybe_remat(block, cfg)
        for bp in params["blocks"]:
            h, m = block(h, bp)
            metrics = {k: metrics.get(k, 0.0) + v for k, v in m.items()}
    elif cfg.family == "rwkv6":
        h = layernorm(params["ln0"], h, cfg.norm_eps)

        def block(x, bp):
            return _rwkv_block_forward(bp, x, cfg, executor=executor)[0]

        block = _maybe_remat(block, cfg)
        for bp in params["blocks"]:
            h = block(h, bp)
    else:
        emb0 = h

        def group(x, emb0, mamba_group, lora_p):
            for bp in mamba_group:
                y, _ = mamba_lib.mamba_forward(bp, x, cfg, executor=executor)
                x = x + y
            x2 = torch.cat([x, emb0], dim=-1)
            delta, _ = _zamba_shared_forward(params["shared"], lora_p, x2,
                                             cfg, positions, executor=executor)
            return x + delta

        group = _maybe_remat(group, cfg)
        G, _ = _zamba_groups(cfg)
        for g in range(G):
            h = group(h, emb0, params["mamba"][g], params["lora"][g])
    return _head(params, cfg, h, executor), metrics


def _maybe_remat(fn, cfg):
    """Activation checkpointing of a block (a Zamba2 group) as
    ``cfg.remat`` asks: ``"block"`` keeps the block's inputs and recomputes
    the rest in backward (``jax.checkpoint``); ``"dots"`` also keeps the
    matrix products' outputs and recomputes the elementwise work
    (``dots_with_no_batch_dims_saveable``), by selective checkpointing.
    Both non-reentrant; ``"none"`` keeps everything.  A recomputed forward
    launches its kernels again."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("block", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    from torch.utils.checkpoint import checkpoint

    kw = {}
    if cfg.remat == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return remat


#: the matrix products without batch dimensions
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: save the outputs of
    the matrix products without batch dimensions, as
    ``dots_with_no_batch_dims_saveable``; recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def loss_fn(params, cfg, batch, *, executor=None):
    """``batch``: {"tokens" | "embeds", "labels"} -> (loss, metrics).

    The loss is the mean over tokens of logsumexp(logits) - the label's
    logit, ``metrics["ce_loss"]``; the MoE family adds
    ``router_aux_weight * moe_lb_loss / L + 1e-3 * moe_z_loss / L`` (the
    router losses summed over the layers).  The label logit is a
    ``gather``: the same number as the JAX package's one-hot contraction
    (one term and zeros), which it chose only for a vocab axis sharded over
    a mesh."""
    logits, metrics = forward(params, cfg, tokens=batch.get("tokens"),
                              embeds=batch.get("embeds"), executor=executor)
    labels = batch["labels"].to(device=logits.device, dtype=torch.int64)
    log_z = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels[..., None])[..., 0]
    loss = torch.mean(log_z - label_logit)
    metrics = dict(metrics)
    metrics["ce_loss"] = loss
    if cfg.family == "moe":
        aux = cfg.router_aux_weight * metrics.get("moe_lb_loss", 0.0) / cfg.n_layers
        aux = aux + 1e-3 * metrics.get("moe_z_loss", 0.0) / cfg.n_layers
        loss = loss + aux
    metrics["loss"] = loss
    return loss, metrics


# =============================================================================
# caches / serving
# =============================================================================


def init_cache(cfg, batch: int, s_max: int, device=None):
    """The zeroed cache on ``device`` (the card unless asked otherwise):
    a :class:`KVCache` ``(n_layers, B, Hkv, s_max, D)`` for the dense and
    MoE families, an :class:`MLACache` ``(n_layers, B, s_max, kvr)`` /
    ``(n_layers, B, s_max, dr)`` for MLA, for the hybrid family the Mamba
    state ``(G, per, B, ...)`` and KV cache ``(G, B, Hkv, s_max, D)``, for
    RWKV6 an :class:`RWKVState` of WKV states ``(n_layers, B, H, K, V)`` f32
    and token shifts ``(n_layers, B, d)`` (no position axis: ``s_max`` is
    not used)."""
    _check_family(cfg)
    dev = torch.device(device) if device is not None else default_device()
    dt = _dtype(cfg)
    L = cfg.n_layers

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if cfg.family in ("dense", "moe"):
        shape = (L, batch, cfg.n_kv_heads, s_max, cfg.resolved_head_dim)
        return KVCache(k=zeros(*shape), v=zeros(*shape))
    if cfg.family == "mla":
        return MLACache(c_kv=zeros(L, batch, s_max, cfg.kv_lora_rank),
                        k_rope=zeros(L, batch, s_max, cfg.qk_rope_head_dim))
    if cfg.family == "rwkv6":
        H, K = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        return RWKVState(wkv=zeros(L, batch, H, K, K, dtype=torch.float32),
                         shift_tm=zeros(L, batch, cfg.d_model),
                         shift_cm=zeros(L, batch, cfg.d_model))
    G, per = _zamba_groups(cfg)
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    scfg = _shared_cfg(cfg)
    kv_shape = (G, batch, scfg.n_kv_heads, s_max, scfg.resolved_head_dim)
    return {
        "mamba": MambaState(
            conv=zeros(G, per, batch, cfg.ssm_conv - 1, conv_dim),
            ssm=zeros(G, per, batch, H, cfg.ssm_state, cfg.ssm_head_dim,
                      dtype=torch.float32),
        ),
        "kv": KVCache(k=zeros(*kv_shape), v=zeros(*kv_shape)),
    }


def cache_axes(cfg):
    """Logical axes of :func:`init_cache`'s tree, leaf for leaf."""
    _check_family(cfg)
    kv = (None, "batch", "kv_heads", "kv_seq", None)
    if cfg.family in ("dense", "moe"):
        return KVCache(k=kv, v=kv)
    if cfg.family == "mla":
        return MLACache(c_kv=(None, "batch", "kv_seq", None),
                        k_rope=(None, "batch", "kv_seq", None))
    if cfg.family == "rwkv6":
        return RWKVState(wkv=(None, "batch", "heads", None, None),
                         shift_tm=(None, "batch", "embed"),
                         shift_cm=(None, "batch", "embed"))
    return {
        "mamba": MambaState(conv=(None, None, "batch", None, "mlp"),
                            ssm=(None, None, "batch", "heads", None, None)),
        "kv": KVCache(k=kv, v=kv),
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
    """Process a prompt (``tokens`` (B, S), or ``embeds`` (B, S, d) for a
    stub-frontend model), fill the cache at offset 0 (in place), return the
    logits (B, S, vocab) f32 and the cache."""
    _check_family(cfg)
    B, S = _batch_len(tokens, embeds)
    dev = (tokens if tokens is not None else embeds).device
    positions = _positions(B, S, 0, dev)
    h = _inputs_to_h(params, cfg, tokens, embeds, positions)
    if cfg.family in _TRANSFORMER:
        for i, bp in enumerate(params["blocks"]):
            h, _, _ = _tf_block(bp, h, cfg, positions=positions,
                                cache=_tf_layer_cache(cache, i),
                                mode="prefill", executor=executor)
        return _head(params, cfg, h, executor), cache
    if cfg.family == "rwkv6":
        # the WKV scan starts from zero, whatever the cache holds (C5)
        h = layernorm(params["ln0"], h, cfg.norm_eps)
        for i, bp in enumerate(params["blocks"]):
            h, st = _rwkv_block_forward(bp, h, cfg, _rwkv_layer(cache, i),
                                        executor=executor)
            _rwkv_store(cache, i, st)
        return _head(params, cfg, h, executor), cache
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
    """One-token step of ``tokens`` (B, 1), or ``embeds`` (B, 1, d) for a
    stub-frontend model; ``length`` = tokens already in the cache.  Updates
    the cache in place; returns logits (B, 1, vocab) f32 and the cache."""
    _check_family(cfg)
    length = int(length)
    B, _ = _batch_len(tokens, embeds)
    dev = (tokens if tokens is not None else embeds).device
    positions = _positions(B, 1, length, dev)
    h = _inputs_to_h(params, cfg, tokens, embeds, positions)
    if cfg.family in _TRANSFORMER:
        for i, bp in enumerate(params["blocks"]):
            h, _, _ = _tf_block(bp, h, cfg, cache=_tf_layer_cache(cache, i),
                                length=length, mode="decode",
                                executor=executor)
        return _head(params, cfg, h, executor), cache
    if cfg.family == "rwkv6":
        h = layernorm(params["ln0"], h, cfg.norm_eps)
        for i, bp in enumerate(params["blocks"]):
            h, st = _rwkv_block_step(bp, h, cfg, _rwkv_layer(cache, i))
            _rwkv_store(cache, i, st)
        return _head(params, cfg, h, executor), cache
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
