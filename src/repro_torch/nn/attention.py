"""Attention layers: GQA (llama-style) with a KV cache, the chunked
online-softmax variant, and MLA (DeepSeek / MiniCPM3-style multi-head latent
attention).

The port of ``repro/nn/attention.py``.  The core softmax attention is the
registered ``nn_attention`` operation (reference and torch = the dense plain
version, cuda = the flash kernel).  Decode (one token against the cache) is
plain PyTorch, as in the JAX package: a matrix-vector product over the cache
that needs no kernel.

``cfg.attn_impl == "chunked"`` sends the reference and torch spaces to
:func:`attention_chunked`, the JAX package's ``attention_xla_chunked``
forward: an online-softmax loop over kv chunks that never materialises the
(S, Skv) scores, with the JAX package's flash-style custom backward.  The
cuda space always takes the flash kernel, as the JAX package's pallas space
does; its gradient recomputes the dense plain version
(``repro_torch.kernels._autograd``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import registry
from repro_torch.core.executor import current_executor
from repro_torch.kernels._autograd import needs_grad
from repro_torch.nn.common import Initializer
from repro_torch.nn.layers import apply_rope, rmsnorm, rmsnorm_init

__all__ = ["attention_chunked", "KVCache", "decode_attention", "gqa_init",
           "gqa_forward", "gqa_prefill", "gqa_decode", "MLACache", "mla_init",
           "mla_forward", "mla_prefill", "mla_decode"]

_attention_op = registry.operation("nn_attention")

NEG_INF = float("-inf")


# =============================================================================
# chunked attention (the flash algorithm in plain PyTorch, a loop over kv
# chunks with running softmax statistics)
# =============================================================================


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, scale: Optional[float] = None,
                      chunk: int = 512) -> torch.Tensor:
    """Softmax attention of q (B, Hq, S, D) over k (B, Hkv, Skv, D) and v
    (B, Hkv, Skv, Dv), Hkv dividing Hq, causal with query i at position
    i + Skv - S; in f32, out in q's dtype.  kv is taken ``chunk`` rows at a
    time (the last chunk padded), never the whole (S, Skv) score matrix.

    Differentiable by the JAX package's custom VJP (``core_fwd`` /
    ``core_bwd``): backward saves q, k, v, out and the rows' logsumexp and
    re-derives each chunk's probabilities in a second loop."""
    B, Hq, S, D = q.shape
    _, Hkv, Skv, _ = k.shape
    Dv = v.shape[-1]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    chunk = min(chunk, Skv)
    pkv = -(-Skv // chunk) * chunk
    if pkv != Skv:
        k = F.pad(k, (0, 0, 0, pkv - Skv))
        v = F.pad(v, (0, 0, 0, pkv - Skv))
    qg = q.reshape(B, Hkv, group, S, D)
    args = (float(scale), bool(causal), int(chunk), int(Skv))
    if needs_grad((qg, k, v)):
        out = _ChunkedAttention.apply(qg, k, v, *args)
    else:
        out = _chunked_forward(qg, k, v, *args)[0]
    return out.reshape(B, Hq, S, Dv)


def _masked_scores(qf, ks, ki, scale, causal, chunk, kv_len, first_pos=None):
    """Chunk ``ki``'s scores (B, Hkv, g, S, chunk), -inf where masked; the
    first row of ``qf`` sits at position ``first_pos`` (default kv_len - S)."""
    S = qf.shape[3]
    dev = qf.device
    if first_pos is None:
        first_pos = kv_len - S
    s = torch.einsum("bhgsd,bhtd->bhgst", qf, ks.to(torch.float32)) * scale
    kv_idx = ki * chunk + torch.arange(chunk, device=dev)
    mask = kv_idx[None, :] < kv_len
    if causal:
        q_pos = torch.arange(S, device=dev) + first_pos
        mask = mask & (q_pos[:, None] >= kv_idx[None, :])
    return torch.where(mask, s, NEG_INF)


def _chunked_forward(q, k, v, scale, causal, chunk, kv_len):
    """(out, lse) of q (B, Hkv, g, S, D) over padded k, v (B, Hkv, pkv, *):
    the online-softmax loop over kv chunks."""
    B, Hkv, g, S, _ = q.shape
    Dv = v.shape[-1]
    dev = q.device
    qf = q.to(torch.float32)
    m = torch.full((B, Hkv, g, S, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, g, S, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, g, S, Dv), dtype=torch.float32, device=dev)
    off = kv_len - S  # query row i sits at position i + off
    for ki in range(k.shape[2] // chunk):
        # causal: the rows before r0 see none of this chunk, and for them
        # the update is the identity (m kept; corr 1, or 0 on a zero l and
        # acc), so they are left out: a causal prefill does half the work
        r0 = min(S, max(0, ki * chunk - off)) if causal else 0
        if r0 == S:
            break
        ks = k[:, :, ki * chunk:(ki + 1) * chunk]
        vs = v[:, :, ki * chunk:(ki + 1) * chunk].to(torch.float32)
        s = _masked_scores(qf[:, :, :, r0:], ks, ki, scale, causal, chunk,
                           kv_len, r0 + off)
        mr = m[:, :, :, r0:]
        m_new = torch.maximum(mr, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(m_new == NEG_INF, 0.0, m_new)
        # m_safe is finite, so a masked score's exp(-inf) is exactly 0
        p = torch.exp(s - m_safe)
        corr = torch.where(mr == NEG_INF, 0.0, torch.exp(mr - m_safe))
        l[:, :, :, r0:] = corr * l[:, :, :, r0:] + p.sum(dim=-1, keepdim=True)
        acc[:, :, :, r0:] = (acc[:, :, :, r0:] * corr
                             + torch.einsum("bhgst,bhtd->bhgsd", p, vs))
        m[:, :, :, r0:] = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe).to(q.dtype)
    lse = torch.where(m == NEG_INF, NEG_INF, m + torch.log(l_safe))
    return out, lse


class _ChunkedAttention(torch.autograd.Function):
    """The chunked attention's custom backward (the JAX package's
    ``core_fwd`` / ``core_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, chunk, kv_len):
        out, lse = _chunked_forward(q, k, v, scale, causal, chunk, kv_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, chunk, kv_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        scale, causal, chunk, kv_len = ctx.args
        qf = q.to(torch.float32)
        doutf = dout.to(torch.float32)
        # D_i = sum_d dout * out (per row)
        drow = torch.sum(doutf * out.to(torch.float32), dim=-1, keepdim=True)
        lse_safe = torch.where(lse == NEG_INF, 0.0, lse)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dks, dvs = [], []
        for ki in range(k.shape[2] // chunk):
            ks = k[:, :, ki * chunk:(ki + 1) * chunk].to(torch.float32)
            vs = v[:, :, ki * chunk:(ki + 1) * chunk].to(torch.float32)
            s = _masked_scores(qf, ks, ki, scale, causal, chunk, kv_len)
            p = torch.where(s == NEG_INF, 0.0, torch.exp(s - lse_safe))
            dvs.append(torch.einsum("bhgst,bhgsd->bhtd", p, doutf))
            dp = torch.einsum("bhgsd,bhtd->bhgst", doutf, vs)
            ds = p * (dp - drow) * scale
            dq = dq + torch.einsum("bhgst,bhtd->bhgsd", ds, ks)
            dks.append(torch.einsum("bhgst,bhgsd->bhtd", ds, qf))
        dk = torch.cat(dks, dim=2)
        dv = torch.cat(dvs, dim=2)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def _attention_core(q, k, v, cfg, causal=True, scale=None, executor=None):
    """Dispatch: the chunked variant outside the cuda space when the
    configuration asks for it, else the registered operation."""
    if cfg is not None and cfg.attn_impl == "chunked":
        ex = executor if executor is not None else current_executor()
        if ex.kernel_space != "cuda":
            chunk = cfg.attn_chunk
            if chunk is None:
                chunk = ex.launch_config(
                    "nn_attention_chunked",
                    {"S": q.shape[2], "Skv": k.shape[2], "D": q.shape[-1],
                     "itemsize": q.element_size()})["chunk"]
            return attention_chunked(q, k, v, causal=causal, scale=scale,
                                     chunk=chunk)
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
        "wq": ini.param((d, H * hd), ("embed", "heads"), std=d ** -0.5),
        "wk": ini.param((d, Hkv * hd), ("embed", "kv_heads"), std=d ** -0.5),
        "wv": ini.param((d, Hkv * hd), ("embed", "kv_heads"), std=d ** -0.5),
        "wo": ini.param((H * hd, d), ("heads", "embed"),
                        std=(H * hd) ** -0.5),
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


# =============================================================================
# MLA attention (MiniCPM3 / DeepSeek-style multi-head latent attention)
# =============================================================================


@dataclasses.dataclass
class MLACache:
    """The latent cache: compressed kv (B, Smax, kv_lora_rank) and the rope
    key shared by the heads (B, Smax, qk_rope_head_dim).  :meth:`write`
    updates the tensors in place, like :class:`KVCache`."""

    c_kv: torch.Tensor
    k_rope: torch.Tensor

    @staticmethod
    def zeros(batch, s_max, kv_rank, rope_dim, dtype, device) -> "MLACache":
        return MLACache(
            c_kv=torch.zeros((batch, s_max, kv_rank), dtype=dtype, device=device),
            k_rope=torch.zeros((batch, s_max, rope_dim), dtype=dtype,
                               device=device),
        )

    def write(self, pos: int, c_kv_new: torch.Tensor,
              k_rope_new: torch.Tensor) -> "MLACache":
        """Insert (B, T, ...) at sequence offset ``pos``."""
        T = c_kv_new.shape[1]
        if not 0 <= pos <= self.c_kv.shape[1] - T:
            raise ValueError(f"cache write of {T} positions at {pos} past its "
                             f"length {self.c_kv.shape[1]}")
        self.c_kv[:, pos:pos + T] = c_kv_new.to(self.c_kv.dtype)
        self.k_rope[:, pos:pos + T] = k_rope_new.to(self.k_rope.dtype)
        return self


def mla_init(ini: Initializer, cfg) -> dict:
    """The projections in the model's dtype; the q and kv norms too (the
    JAX package gives them the model's dtype, unlike the block norms)."""
    d = cfg.d_model
    H = cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "q_down": ini.param((d, qr), ("embed", None), std=d ** -0.5),
        "q_norm": rmsnorm_init(ini, qr, dtype=ini.dtype),
        "q_up": ini.param((qr, H * (dn + dr)), (None, "heads"),
                          std=qr ** -0.5),
        "kv_down": ini.param((d, kvr + dr), ("embed", None), std=d ** -0.5),
        "kv_norm": rmsnorm_init(ini, kvr, dtype=ini.dtype),
        "k_up": ini.param((kvr, H * dn), (None, "heads"), std=kvr ** -0.5),
        "v_up": ini.param((kvr, H * dv), (None, "heads"), std=kvr ** -0.5),
        "wo": ini.param((H * dv, d), ("heads", "embed"),
                        std=(H * dv) ** -0.5),
    }


def _mla_qkv(p, x, cfg, positions, executor=None):
    """Per-head q, k, v materialised from the latents (the prefill and
    forward path), with the latent c_kv and the rotated shared rope key."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank

    cq = rmsnorm(p["q_norm"], x @ p["q_down"], cfg.norm_eps, executor=executor)
    q = (cq @ p["q_up"]).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv = x @ p["kv_down"]  # (B, S, kvr + dr)
    c_kv, k_rope = kv[..., :kvr], kv[..., kvr:]
    c_kv_n = rmsnorm(p["kv_norm"], c_kv, cfg.norm_eps, executor=executor)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)  # shared by the heads

    k_nope = (c_kv_n @ p["k_up"]).reshape(B, S, H, dn)
    v = (c_kv_n @ p["v_up"]).reshape(B, S, H, dv)

    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)],
                       dim=-1)
    return q_full, k_full, v, c_kv, k_rope


def _mla_attention(q_full, k_full, v, cfg, scale, executor):
    """MLA's core attention with dv != dqk.  The reference, torch and
    chunked routes take v at its own head dim (the softmax weights depend on
    q and k only); the flash kernel wants one head dim for k and v, so the
    cuda space alone pads v to dqk and slices the output back."""
    dv, dqk = v.shape[-1], q_full.shape[-1]
    ex = executor if executor is not None else current_executor()
    v_in = v
    if ex.kernel_space == "cuda" and dv < dqk:
        v_in = F.pad(v, (0, dqk - dv))
    out = _attention_core(q_full.transpose(1, 2), k_full.transpose(1, 2),
                          v_in.transpose(1, 2), cfg, causal=True, scale=scale,
                          executor=executor)
    return out.transpose(1, 2)[..., :dv]


def _mla_scale(cfg) -> float:
    return 1.0 / ((cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** 0.5)


def mla_forward(p, x, cfg, positions, *, executor=None):
    B, S, _ = x.shape
    q_full, k_full, v, _, _ = _mla_qkv(p, x, cfg, positions, executor)
    out = _mla_attention(q_full, k_full, v, cfg, _mla_scale(cfg), executor)
    return out.reshape(B, S, -1) @ p["wo"]


def mla_prefill(p, x, cfg, positions, cache: MLACache, *, executor=None):
    """The causal forward that also fills the latent cache at offset 0."""
    B, S, _ = x.shape
    q_full, k_full, v, c_kv, k_rope = _mla_qkv(p, x, cfg, positions, executor)
    out = _mla_attention(q_full, k_full, v, cfg, _mla_scale(cfg), executor)
    cache = cache.write(0, c_kv, k_rope)
    return out.reshape(B, S, -1) @ p["wo"], cache


def mla_decode(p, x, cfg, length: int, cache: MLACache, *, executor=None):
    """Latent-cache decode in the absorbed form: q_nope is absorbed into
    k_up and the probabilities into v_up, so each cached token is read as
    its (kvr + dr) latents.  The kv norm runs over the whole cache every
    step, as in the JAX package."""
    B = x.shape[0]
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    pos = torch.full((B, 1), length, dtype=torch.int32, device=x.device)

    cq = rmsnorm(p["q_norm"], x @ p["q_down"], cfg.norm_eps, executor=executor)
    q = (cq @ p["q_up"]).reshape(B, 1, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)

    kv = x @ p["kv_down"]
    c_kv_new, k_rope_new = kv[..., :kvr], kv[..., kvr:]
    k_rope_new = apply_rope(k_rope_new, pos, cfg.rope_theta)
    cache = cache.write(length, c_kv_new, k_rope_new)

    c_kv_n = rmsnorm(p["kv_norm"], cache.c_kv, cfg.norm_eps,
                     executor=executor).to(torch.float32)  # (B, Smax, kvr)
    f32 = torch.float32
    k_up = p["k_up"].reshape(kvr, H, dn).to(f32)
    q_abs = torch.einsum("bshd,khd->bshk", q_nope.to(f32), k_up)
    s_nope = torch.einsum("bshk,btk->bhst", q_abs, c_kv_n)
    s_rope = torch.einsum("bshd,btd->bhst", q_rope.to(f32),
                          cache.k_rope.to(f32))
    s = (s_nope + s_rope) / ((dn + dr) ** 0.5)
    valid = torch.arange(cache.c_kv.shape[1], device=x.device) < length + 1
    s = s.masked_fill(~valid, NEG_INF)
    pattn = torch.softmax(s, dim=-1)  # (B, H, 1, Smax)
    ctx = torch.einsum("bhst,btk->bshk", pattn, c_kv_n)
    v_up = p["v_up"].reshape(kvr, H, dv).to(f32)
    out = torch.einsum("bshk,khd->bshd", ctx, v_up)
    out = out.reshape(B, 1, H * dv).to(x.dtype)
    return out @ p["wo"], cache
