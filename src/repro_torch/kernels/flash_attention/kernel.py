"""Causal GQA flash attention: the wrapper of the CUDA kernel
``csrc/flash_attention.cu`` and its plain PyTorch version.

``flash_attention`` launches the kernel for CUDA tensors and counts the
launch in ``flash_attention.launches``; for CPU tensors it returns the plain
version.  There is no fallback from a failed build or launch: the error
propagates.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, _cost
from repro_torch.kernels._check import on_cuda, require

__all__ = ["flash_attention", "flash_attention_plain", "flash_smem_bytes",
           "flash_block_kv", "flash_tile_plan", "BLOCK_Q"]

_P = ctypes.c_void_p
_ENTRY = {torch.float32: "repro_flash_attention_f32",
          torch.bfloat16: "repro_flash_attention_bf16",
          torch.float16: "repro_flash_attention_f16"}
_I = ctypes.c_int
_ARGS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P)

#: query rows a block and kv rows a tile of the tensor-core kernel (kWgBQ,
#: kWgBKV in the source); the f32 kernel's are kBQ = 64 and kFmaBKV = 32
BLOCK_Q = 128
MAX_HEAD_DIM = 256
#: the source's slab width (kSlab: 64 columns, one 128-byte swizzle span),
#: the shared memory a block may use (kSmemLimit) and the barriers' bytes
SLAB = 64
SMEM_LIMIT = 232_448
BAR_BYTES = 128


def flash_block_kv(itemsize: int) -> int:
    return 64 if itemsize == 2 else 32


def flash_tile_plan(D: int) -> dict:
    """The tensor-core kernel's shared memory at head dim D (``WgGeom`` in
    the source): Q and every K / V tile come in ``slabs`` column slabs of 64
    (the last zero-filled past D), K and V in a ring of ``stages``."""
    slabs = -(-D // SLAB)
    q_bytes = slabs * BLOCK_Q * 2 * SLAB
    stage_bytes = 2 * slabs * flash_block_kv(2) * 2 * SLAB
    stages = 3 if q_bytes + 3 * stage_bytes + BAR_BYTES + 1024 <= SMEM_LIMIT else 2
    return {"slabs": slabs, "q_bytes": q_bytes, "stage_bytes": stage_bytes,
            "stages": stages,
            "smem_bytes": q_bytes + stages * stage_bytes + BAR_BYTES + 1024,
            "last_slab_cols": D - (slabs - 1) * SLAB}


def flash_smem_bytes(D: int, itemsize: int) -> int:
    """Dynamic shared memory of one block: the tensor-core kernel's
    (:func:`flash_tile_plan`) for 2-byte inputs, the f32 kernel's
    (``smem_bytes`` in the source, 64 query rows) for 4-byte ones."""
    if itemsize == 2:
        return flash_tile_plan(D)["smem_bytes"]
    bq, bkv = 64, flash_block_kv(itemsize)
    return 4 * (bq * (D + 1) + bkv * (D + 1) + bkv * D
                + bq * (bkv + 1) + 3 * bq)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Dense softmax attention with GQA head sharing, in f32 (f64 for f64
    inputs), with the flash kernel's semantics at the edges: query i sits
    at position i + Skv - S, and a row that sees no key (Skv < S) is 0,
    where a plain softmax would give NaN."""
    B, Hq, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    kf = torch.repeat_interleave(k, group, dim=1).to(ct)
    vf = torch.repeat_interleave(v, group, dim=1).to(ct)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), kf) * scale
    if causal:
        q_idx = torch.arange(S, device=q.device)[:, None] + (Skv - S)
        kv_idx = torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(~(q_idx >= kv_idx), float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s - m)  # exp(-inf) = 0 on masked entries
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf) / l
    return out.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention of q (B, Hq, S, D) over k, v (B, Hkv, Skv, D), Hkv
    dividing Hq; causal with ``kv_offset = Skv - S``; out in q's dtype.
    bf16 / fp16 run on the tensor cores (TMA loads, wgmma products), f32 on
    the CUDA cores."""
    name = "flash_attention"
    require(q.ndim == 4 and k.ndim == 4 and v.ndim == 4, name,
            "q, k, v must be (B, H, S, D)")
    B, Hq, S, D = q.shape
    require(k.shape == v.shape and k.shape[0] == B and k.shape[3] == D, name,
            f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q "
            f"{tuple(q.shape)}")
    Hkv, Skv = k.shape[1], k.shape[2]
    require(Hkv >= 1 and Hq % Hkv == 0, name, f"Hq={Hq} not divisible by Hkv={Hkv}")
    require(q.dtype in _ENTRY and k.dtype == q.dtype and v.dtype == q.dtype,
            name, f"q/k/v dtypes ({q.dtype}, {k.dtype}, {v.dtype}) must be one "
            f"of {sorted(map(str, _ENTRY))}")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if _cost.recording():
        # causal: query i sees keys up to i + Skv - S
        if causal:
            seen = (S * max(Skv - S, 0) + S * (S + 1) // 2 if Skv >= S
                    else Skv * (Skv + 1) // 2)
        else:
            seen = S * Skv
        return _cost.unit(name, (q, k, v), torch.empty_like(q),
                          4 * D * B * Hq * seen)
    if not on_cuda(name, q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    require(D % 16 == 0 and 16 <= D <= MAX_HEAD_DIM, name,
            f"head dim {D} must be a multiple of 16 in [16, {MAX_HEAD_DIM}]")
    require(Hq <= 65535 and B <= 65535, name, f"grid ({Hq} heads, {B} "
            "batch) exceeds the launch limits")
    require(Skv >= 1, name, "no key rows")
    require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)), name,
            "q, k, v must start on 16-byte boundaries (TMA and 16-byte loads)")
    out = torch.empty_like(q)
    if out.numel():
        fn = _build.function(_ENTRY[q.dtype], _ARGS)
        _build.check(name, fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, S, Skv, D, float(scale), int(causal), _build.stream_of(q)))
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
