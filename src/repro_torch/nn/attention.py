"""Attention layers: grouped-query attention (llama-style) with a KV cache.

The port of the GQA part of ``repro/nn/attention.py``.  The core softmax
attention is the registered ``nn_attention`` operation (reference and torch
= the dense plain version, cuda = the flash kernel).  Decode (one token
against the cache) is plain PyTorch, as in the JAX package: a matrix-vector
product over the cache that needs no kernel.

The JAX package's chunked-scan variant (``cfg.attn_impl == "chunked"``)
and MLA are not ported yet (ROADMAP A15).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import registry
from repro_torch.nn.common import Initializer
from repro_torch.nn.layers import apply_rope

__all__ = ["KVCache", "decode_attention", "gqa_init", "gqa_forward",
           "gqa_prefill", "gqa_decode"]

_attention_op = registry.operation("nn_attention")

NEG_INF = float("-inf")


def _attention_core(q, k, v, cfg, causal=True, scale=None, executor=None):
    """Dispatch to the registered operation (the chunked variant raises)."""
    if cfg is not None and cfg.attn_impl == "chunked":
        raise NotImplementedError(
            "attn_impl='chunked' (the JAX package's attention_xla_chunked) is "
            "not ported to repro_torch yet (ROADMAP A15)")
    return _attention_op(q, k, v, causal=causal, scale=scale, executor=executor)


# =============================================================================
# KV cache
# =============================================================================


@dataclasses.dataclass
class KVCache:
    """k and v (B, Hkv, Smax, D).  Unlike the JAX package's immutable cache,
    :meth:`write` updates the tensors in place (no copy of the cache per
    step) and returns the same object."""

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def zeros(batch, n_kv, s_max, d, dtype, device) -> "KVCache":
        return KVCache(
            k=torch.zeros((batch, n_kv, s_max, d), dtype=dtype, device=device),
            v=torch.zeros((batch, n_kv, s_max, d), dtype=dtype, device=device),
        )

    def write(self, pos: int, k_new: torch.Tensor, v_new: torch.Tensor) -> "KVCache":
        """Insert (B, Hkv, T, D) at sequence offset ``pos``."""
        T = k_new.shape[2]
        if not 0 <= pos <= self.k.shape[2] - T:
            raise ValueError(f"cache write of {T} positions at {pos} past its "
                             f"length {self.k.shape[2]}")
        self.k[:, :, pos:pos + T] = k_new.to(self.k.dtype)
        self.v[:, :, pos:pos + T] = v_new.to(self.v.dtype)
        return self


def decode_attention(q: torch.Tensor, cache: KVCache, length: int,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention of q (B, Hq, 1, D) against the cache's first
    ``length`` positions (the current one included), in f32."""
    B, Hq, _, D = q.shape
    Hkv = cache.k.shape[1]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, Hkv, group, D).to(torch.float32)
    s = torch.einsum("bhgd,bhtd->bhgt", qg, cache.k.to(torch.float32)) * scale
    valid = torch.arange(cache.k.shape[2], device=q.device) < length
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgt,bhtd->bhgd", p, cache.v.to(torch.float32))
    return out.reshape(B, Hq, 1, D).to(q.dtype)


# =============================================================================
# GQA attention layer
# =============================================================================


def gqa_init(ini: Initializer, cfg) -> dict:
    d = cfg.d_model
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "wq": ini.param((d, H * hd), std=d ** -0.5),
        "wk": ini.param((d, Hkv * hd), std=d ** -0.5),
        "wv": ini.param((d, Hkv * hd), std=d ** -0.5),
        "wo": ini.param((H * hd, d), std=(H * hd) ** -0.5),
    }


def _qkv(p, x, cfg, positions):
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, Hkv, hd)
    v = (x @ p["wv"]).reshape(B, S, Hkv, hd)
    if cfg.pos_kind == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def gqa_forward(p, x: torch.Tensor, cfg, positions: torch.Tensor, *,
                executor=None) -> torch.Tensor:
    """Full (training / prefill) causal forward of x (B, S, d)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    out = _attention_core(q, k, v, cfg, causal=True, executor=executor)
    return out.transpose(1, 2).reshape(B, S, -1) @ p["wo"]


def gqa_prefill(p, x, cfg, positions, cache: KVCache, *, executor=None):
    """Prefill: the causal forward that also fills the cache at offset 0."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    out = _attention_core(q, k, v, cfg, causal=True, executor=executor)
    cache = cache.write(0, k, v)
    return out.transpose(1, 2).reshape(B, S, -1) @ p["wo"], cache


def gqa_decode(p, x, cfg, length: int, cache: KVCache, *, executor=None):
    """One-token step; ``length`` = tokens already in the cache (the
    current position)."""
    B = x.shape[0]
    pos = torch.full((B, 1), length, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, cfg, pos)
    cache = cache.write(length, k, v)
    out = decode_attention(q, cache, length + 1)
    return out.transpose(1, 2).reshape(B, 1, -1) @ p["wo"], cache
