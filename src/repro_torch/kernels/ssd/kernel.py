"""Mamba2 SSD chunked scan: the wrapper of the CUDA kernel
``csrc/ssd_scan.cu`` and its plain PyTorch version.

``ssd_scan`` launches the kernel for CUDA tensors and counts the launch in
``ssd_scan.launches``; for CPU tensors it returns the plain version, the
chunked formulation of the JAX package's ``ssd_chunked_xla``.  There is no
fallback from a failed build or launch: the error propagates.

x, B and C may be strided views with a unit-stride last dimension (the
serving path cuts them from one conv output): the kernel takes their other
strides, so nothing is copied.  bf16 inputs that ``ssd_tensor_cores``
accepts (P and N multiples of 8, rows 16-byte aligned) run the tensor-core
kernel (four warps per (batch, head), chunk products by ``mma.sync`` with
f32 operands split into bf16 hi + lo); f32, fp16 and other bf16 inputs run
the CUDA-core kernel (256 threads per (batch, head), f32 FMA products).
``ssd_smem_bytes`` mirrors each one's shared memory.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, _cost
from repro_torch.kernels._check import on_cuda, require

__all__ = ["ssd_scan", "ssd_scan_plain", "ssd_smem_bytes", "ssd_tensor_cores",
           "CHUNK", "MAX_DIM"]

_P = ctypes.c_void_p
_ENTRY = {torch.float32: "repro_ssd_scan_f32",
          torch.bfloat16: "repro_ssd_scan_bf16",
          torch.float16: "repro_ssd_scan_f16"}
_MMA_ENTRY = "repro_ssd_scan_bf16_mma"
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ARGS = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I) + (_LL,) * 9 + (_P,)

#: the chunk length the source compiles (kL) and the largest N and P (kW)
CHUNK = 64
MAX_DIM = 64


def ssd_smem_bytes(tensor_cores: bool = True) -> int:
    """Dynamic shared memory of one block: the tensor-core kernel's
    (``SsdSmem::kBytes``: two stages of x, B, C as bf16 rows padded by 8 and
    dt, the state as bf16 hi and lo, each warp's acum and wdt), or the
    CUDA-core kernel's (``fma_smem_bytes``)."""
    L, W = CHUNK, MAX_DIM
    if not tensor_cores:
        return 4 * (L * W + 2 * L * (W + 1) + L * (L + 1) + W * W + 3 * L)
    ld = W + 8
    stage = 2 * 3 * L * ld + 4 * L
    state = 2 * 2 * W * ld
    return 2 * stage + state + 4 * (4 * 2 * L)


def ssd_tensor_cores(x: torch.Tensor, B_mat: torch.Tensor,
                     C: torch.Tensor) -> bool:
    """Whether these inputs run the tensor-core kernel: bf16, P and N
    multiples of 8, x, B and C at 16-byte aligned addresses with every
    stride a multiple of 8 elements (the 16-byte ``cp.async`` rows)."""
    return (x.dtype == torch.bfloat16 and x.shape[-1] % 8 == 0
            and B_mat.shape[-1] % 8 == 0
            and all(t.data_ptr() % 16 == 0
                    and all(s % 8 == 0 for s in _strides(t))
                    for t in (x, B_mat, C)))


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B_mat: torch.Tensor, C: torch.Tensor, *,
                   chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan in batched products, one chunk at a time (the port
    of ``repro/kernels/ssd/xla.py``): zero-padded to whole chunks (dt = 0
    leaves the state unchanged), in f32 (f64 for f64 inputs), y in x's
    dtype, the final state in the compute type."""
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    Bsz, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    group = H // G
    chunk = min(chunk, S)
    pad = -S % chunk
    xf = torch.nn.functional.pad(x.to(ct), (0, 0, 0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.to(ct), (0, 0, 0, pad))
    Bf = torch.nn.functional.pad(B_mat.to(ct), (0, 0, 0, 0, 0, pad))
    Cf = torch.nn.functional.pad(C.to(ct), (0, 0, 0, 0, 0, pad))
    Sp = S + pad
    nc, L = Sp // chunk, chunk
    xf = xf.reshape(Bsz, nc, L, H, P)
    dtf = dtf.reshape(Bsz, nc, L, H)
    Bf = Bf.reshape(Bsz, nc, L, G, N)
    Cf = Cf.reshape(Bsz, nc, L, G, N)
    Af = A.to(ct)
    lower = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))

    h = torch.zeros((Bsz, H, N, P), dtype=ct, device=x.device)
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        acum = torch.cumsum(dtc * Af, dim=1)  # (B, L, H), <= 0
        diff = acum[:, :, None, :] - acum[:, None, :, :]  # (B, L, L, H)
        # masked before the exp: diff > 0 above the diagonal can overflow
        diff = diff.masked_fill(~lower[None, :, :, None], float("-inf"))
        Ldec = torch.exp(diff)
        CB = torch.einsum("blgn,bsgn->blsg", Cc, Bc)
        CBh = torch.repeat_interleave(CB, group, dim=-1)  # (B, L, L, H)
        Gmat = CBh * Ldec * dtc[:, None, :, :]
        y_intra = torch.einsum("blsh,bshp->blhp", Gmat, xc)
        Ch = torch.repeat_interleave(Cc, group, dim=2)  # (B, L, H, N)
        Cs = Ch * torch.exp(acum)[..., None]
        y_inter = torch.einsum("blhn,bhnp->blhp", Cs, h)
        chunk_decay = torch.exp(acum[:, -1, :])  # (B, H)
        Bh = torch.repeat_interleave(Bc, group, dim=2)
        Bs = Bh * (torch.exp(acum[:, -1:, :] - acum) * dtc)[..., None]
        h = chunk_decay[..., None, None] * h + torch.einsum("blhn,blhp->bhnp",
                                                            Bs, xc)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bsz, Sp, H, P)[:, :S]
    return y.to(x.dtype), h


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_mat: torch.Tensor, C: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, final state) of the SSD scan from a zero state: x (Bsz, S, H, P),
    dt (Bsz, S, H) f32, A (H,) f32, B/C (Bsz, S, G, N) in x's dtype; x, B
    and C with a unit-stride last dimension, dt and A contiguous."""
    name = "ssd_scan"
    require(x.ndim == 4 and dt.ndim == 3 and A.ndim == 1 and B_mat.ndim == 4
            and C.ndim == 4, name, "expected x (B,S,H,P), dt (B,S,H), A (H,), "
            "B/C (B,S,G,N)")
    Bsz, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    require(dt.shape == (Bsz, S, H) and A.shape == (H,), name,
            f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do not match x "
            f"{tuple(x.shape)}")
    require(B_mat.shape[:2] == (Bsz, S) and C.shape == B_mat.shape, name,
            f"B {tuple(B_mat.shape)} / C {tuple(C.shape)} do not match x")
    require(G >= 1 and H % G == 0, name, f"H={H} not divisible by G={G}")
    require(x.dtype in _ENTRY and B_mat.dtype == x.dtype and C.dtype == x.dtype,
            name, f"x/B/C dtypes ({x.dtype}, {B_mat.dtype}, {C.dtype}) must be "
            f"one of {sorted(map(str, _ENTRY))}, all alike")
    require(dt.dtype == torch.float32 and A.dtype == torch.float32, name,
            f"dt and A must be float32, got {dt.dtype}, {A.dtype}")
    if _cost.recording():
        L = CHUNK
        out = (torch.empty(x.shape, dtype=x.dtype, device=x.device),
               torch.empty((Bsz, H, N, P), dtype=torch.float32, device=x.device))
        return _cost.unit(name, (x, dt, A, B_mat, C), out,
                          2 * L * (L * N + L * P + 2 * N * P) * Bsz * H
                          * -(-S // L))
    if not on_cuda(name, dt, A, strided=(x, B_mat, C)):
        return ssd_scan_plain(x, dt, A, B_mat, C)
    require(1 <= N <= MAX_DIM and 1 <= P <= MAX_DIM, name,
            f"N={N} and P={P} must be in [1, {MAX_DIM}]")
    require(Bsz <= 65535, name, f"batch {Bsz} exceeds the grid limit")
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    state = torch.empty((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    if S == 0:
        return y, state.zero_()
    entry = _MMA_ENTRY if ssd_tensor_cores(x, B_mat, C) else _ENTRY[x.dtype]
    fn = _build.function(entry, _ARGS)
    _build.check(name, fn(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_mat.data_ptr(),
        C.data_ptr(), y.data_ptr(), state.data_ptr(), Bsz, S, H, P, G, N,
        *_strides(x), *_strides(B_mat), *_strides(C), _build.stream_of(x)))
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0


def _strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """The batch, step and head (group) strides in elements; 0 for a
    dimension of size 1, whose stride the kernel never multiplies."""
    return tuple(t.stride(d) if t.shape[d] > 1 else 0 for d in range(3))
