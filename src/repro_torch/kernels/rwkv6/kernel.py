"""RWKV6 (Finch) WKV chunked scan: the wrapper of the CUDA kernel
``csrc/rwkv6_scan.cu`` and its plain PyTorch version.

``rwkv6_scan_log`` launches the kernel for CUDA tensors and counts the
launch in ``rwkv6_scan_log.launches``; for CPU tensors it returns the plain
version, the chunked formulation of the JAX package's ``rwkv6_chunked_xla``
(ratio-form pairwise decays, masked before the exp).  ``rwkv6_scan`` takes
the decay in linear space.  There is no fallback from a failed build or
launch: the error propagates.

bf16 inputs that ``rwkv6_tensor_cores`` accepts (K and V multiples of 8,
16-byte aligned rows) run the tensor-core kernel: chunks
of ``CHUNK`` = 64, four warps per (batch, head), the pairwise decays
factored across sub-chunks of eight so that only the diagonal 8 x 8 blocks
keep the ratio form, every chunk product by ``mma.sync`` with f32 operands
split into bf16 hi + lo.
f32, fp16 and other bf16 inputs run the CUDA-core kernel (chunks of
``FMA_CHUNK`` = 32, the ratio form for every pair, f32 FMA products).
``rwkv6_smem_bytes`` mirrors each one's shared memory.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, _cost
from repro_torch.kernels._check import on_cuda, require

__all__ = ["rwkv6_scan", "rwkv6_scan_log", "rwkv6_scan_plain",
           "rwkv6_smem_bytes", "rwkv6_tensor_cores", "CHUNK", "FMA_CHUNK",
           "MAX_DIM"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRY = {torch.float32: "repro_rwkv6_scan_f32",
          torch.bfloat16: "repro_rwkv6_scan_bf16",
          torch.float16: "repro_rwkv6_scan_f16"}
_MMA_ENTRY = "repro_rwkv6_scan_bf16_mma"
_ARGS = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)

#: the chunk lengths the source compiles (kL of the tensor-core kernel, kFL
#: of the CUDA-core one) and the largest K and V (kW)
CHUNK = 64
FMA_CHUNK = 32
MAX_DIM = 64


def rwkv6_smem_bytes(tensor_cores: bool = True) -> int:
    """Dynamic shared memory of one block: the tensor-core kernel's
    (``RwkvSmem::kBytes``: r, k, v as bf16 rows padded by 8, W with its zero
    row as f32 rows padded by 4, u, each warp's 16 x 17 diagonal scores, the
    state as bf16 hi and lo), or the CUDA-core kernel's
    (``fma_smem_bytes``)."""
    L, W = CHUNK, MAX_DIM
    if not tensor_cores:
        L = FMA_CHUNK
        return 4 * (5 * L * (W + 1) + W * W + L * (L + 1) + 2 * W)
    ld, ld_w = W + 8, W + 4
    return (2 * 3 * L * ld + 4 * (L + 1) * ld_w + 4 * W + 4 * 4 * 16 * 17
            + 2 * 2 * W * ld)


def rwkv6_tensor_cores(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       logw: torch.Tensor) -> bool:
    """Whether these contiguous inputs run the tensor-core kernel: bf16, K
    and V multiples of 8, r, k, v and logw at 16-byte aligned addresses
    (the 16-byte ``cp.async`` rows)."""
    return (r.dtype == torch.bfloat16 and r.shape[-1] % 8 == 0
            and v.shape[-1] % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (r, k, v, logw)))


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logw: torch.Tensor, u: torch.Tensor, *,
                     chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan in batched products, one chunk at a time (the port
    of ``repro/kernels/rwkv6/xla.py``): zero-padded to whole chunks (r = k
    = 0 and logw = 0 add nothing and leave the state as it was), in f32
    (f64 for f64 inputs), y in r's dtype, the final state in the compute
    type."""
    ct = torch.float64 if r.dtype == torch.float64 else torch.float32
    Bsz, S, H, K = r.shape
    V = v.shape[-1]
    if S == 0:
        return (v.new_zeros((Bsz, 0, H, V), dtype=r.dtype),
                torch.zeros((Bsz, H, K, V), dtype=ct, device=r.device))
    chunk = min(chunk, S)
    pad = -S % chunk

    def chunks(t, d):
        t = torch.nn.functional.pad(t.to(ct), (0, 0, 0, 0, 0, pad))
        return t.reshape(Bsz, (S + pad) // chunk, chunk, H, d)

    rf, kf, vf, lwf = chunks(r, K), chunks(k, K), chunks(v, V), chunks(logw, K)
    uf = u.to(ct)
    L = chunk
    idx = torch.arange(L, device=r.device)
    strict = idx[:, None] > idx[None, :]  # (L, L): s < t

    state = torch.zeros((Bsz, H, K, V), dtype=ct, device=r.device)
    ys = []
    for c in range(rf.shape[1]):
        rc, kc, vc, lw = rf[:, c], kf[:, c], vf[:, c], lwf[:, c]  # (B, L, H, *)
        W = torch.cumsum(lw, dim=1)
        Wprev = W - lw
        y_inter = torch.einsum("blhk,bhkv->blhv", rc * torch.exp(Wprev), state)
        # ratio form: Wprev[t] - W[s] <= 0 for s < t; above the diagonal it
        # is positive and can overflow, so it is masked before the exp
        diff = Wprev[:, :, None] - W[:, None, :]  # (B, L, L, H, K)
        diff = diff.masked_fill(~strict[None, :, :, None, None], 0.0)
        G = (rc[:, :, None] * kc[:, None, :] * torch.exp(diff)).sum(-1)
        G = G.masked_fill(~strict[None, :, :, None], 0.0)  # (B, L, L, H)
        y_intra = torch.einsum("blsh,bshv->blhv", G, vc)
        bonus = (rc * uf[None, None] * kc).sum(-1)  # (B, L, H)
        ys.append(y_inter + y_intra + bonus[..., None] * vc)
        chunk_decay = torch.exp(W[:, -1])  # (B, H, K)
        k_dec = kc * torch.exp(W[:, -1:] - W)  # exponents <= 0
        state = (chunk_decay[..., None] * state
                 + torch.einsum("blhk,blhv->bhkv", k_dec, vc))
    y = torch.stack(ys, dim=1).reshape(Bsz, S + pad, H, V)[:, :S]
    return y.to(r.dtype), state


def rwkv6_scan_log(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logw: torch.Tensor, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, final state) of the WKV6 scan from a zero state: r, k (B, S, H,
    K) and v (B, S, H, V) in the model's dtype, logw (B, S, H, K) f32,
    finite and <= 0, u (H, K) in r's dtype."""
    name = "rwkv6_scan_log"
    require(r.ndim == 4 and k.ndim == 4 and v.ndim == 4 and logw.ndim == 4
            and u.ndim == 2, name, "expected r, k, logw (B,S,H,K), v (B,S,H,V), "
            "u (H,K)")
    Bsz, S, H, K = r.shape
    V = v.shape[-1]
    require(k.shape == r.shape and logw.shape == r.shape
            and v.shape[:3] == (Bsz, S, H) and u.shape == (H, K), name,
            f"k {tuple(k.shape)}, v {tuple(v.shape)}, logw {tuple(logw.shape)}, "
            f"u {tuple(u.shape)} do not match r {tuple(r.shape)}")
    require(r.dtype in _ENTRY and all(t.dtype == r.dtype for t in (k, v, u)),
            name, f"r/k/v/u dtypes ({r.dtype}, {k.dtype}, {v.dtype}, {u.dtype}) "
            f"must be one of {sorted(map(str, _ENTRY))}, all alike")
    require(logw.dtype == torch.float32, name,
            f"logw must be float32, got {logw.dtype}")
    if _cost.recording():
        L = CHUNK
        lower = L * (L - 1) // 2  # pairs s < t of a chunk
        out = (torch.empty((Bsz, S, H, V), dtype=r.dtype, device=r.device),
               torch.empty((Bsz, H, K, V), dtype=torch.float32, device=r.device))
        return _cost.unit(name, (r, k, v, logw, u), out,
                          Bsz * H * -(-S // L) * (4 * L * K * V + 2 * lower * K
                                                  + 4 * lower * V))
    if not on_cuda(name, r, k, v, logw, u):
        return rwkv6_scan_plain(r, k, v, logw, u)
    require(1 <= K <= MAX_DIM and 1 <= V <= MAX_DIM, name,
            f"K={K} and V={V} must be in [1, {MAX_DIM}]")
    require(Bsz <= 65535, name, f"batch {Bsz} exceeds the grid limit")
    y = torch.empty((Bsz, S, H, V), dtype=r.dtype, device=r.device)
    state = torch.empty((Bsz, H, K, V), dtype=torch.float32, device=r.device)
    if S == 0 or Bsz == 0 or H == 0:
        return y, state.zero_()
    entry = (_MMA_ENTRY if rwkv6_tensor_cores(r, k, v, logw)
             else _ENTRY[r.dtype])
    fn = _build.function(entry, _ARGS)
    _build.check(name, fn(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), y.data_ptr(), state.data_ptr(), Bsz, S, H, K, V,
        _build.stream_of(r)))
    rwkv6_scan_log.launches += 1
    return y, state


rwkv6_scan_log.launches = 0


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan with the decay ``w`` in (0, 1) in linear space.

    Prefer :func:`rwkv6_scan_log`: RWKV6 parameterises w = exp(-exp(x)), so
    the layer owns logw = -exp(x) exactly; taking log(w) here loses that and
    underflows for strong decays, hence the clamp at 1e-30 (as in the JAX
    package)."""
    logw = torch.log(torch.clamp(w.to(torch.float32), min=1e-30))
    return rwkv6_scan_log(r, k, v, logw.contiguous(), u)
