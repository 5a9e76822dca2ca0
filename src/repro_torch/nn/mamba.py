"""Mamba2 block (SSD), used by the zamba2 hybrid architecture.

The port of ``repro/nn/mamba.py``: input projection producing (z, x, B, C,
dt), a short causal depthwise conv over (x, B, C), the SSD scan over heads
(the registered ``nn_ssd_scan`` operation: reference = sequential
recurrence, torch = chunked products, cuda = the kernel), gated RMSNorm
(plain PyTorch, as in the JAX package: it is not the ``nn_rmsnorm``
operation), output projection.  Decode keeps a (conv window, ssm state)
recurrent state and steps in O(1) with plain PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import registry
from repro_torch.nn.common import Initializer, ones, zeros

# make sure the kernel spaces are populated
import repro_torch.kernels  # noqa: F401

__all__ = ["MambaState", "mamba_init", "mamba_forward", "mamba_step"]

_ssd_op = registry.operation("nn_ssd_scan")


@dataclasses.dataclass
class MambaState:
    conv: torch.Tensor  # (B, conv_w - 1, conv_dim) rolling conv window
    ssm: torch.Tensor  # (B, H, N, P) f32

    @staticmethod
    def zeros(batch, conv_w, conv_dim, n_heads, d_state, head_dim, dtype,
              device) -> "MambaState":
        return MambaState(
            conv=torch.zeros((batch, conv_w - 1, conv_dim), dtype=dtype,
                             device=device),
            ssm=torch.zeros((batch, n_heads, d_state, head_dim),
                            dtype=torch.float32, device=device),
        )


def _dims(cfg):
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    P = cfg.ssm_head_dim
    H = d_inner // P
    N = cfg.ssm_state
    G = cfg.ssm_groups
    return d, d_inner, H, P, N, G


def mamba_init(ini: Initializer, cfg) -> dict:
    d, d_inner, H, P, N, G = _dims(cfg)
    conv_dim = d_inner + 2 * G * N
    return {
        # in_proj -> [z (d_inner), x (d_inner), B (G*N), C (G*N), dt (H)]
        "in_proj": ini.param((d, 2 * d_inner + 2 * G * N + H), ("embed", "mlp"),
                             std=d ** -0.5),
        "conv_w": ini.param((cfg.ssm_conv, conv_dim), (None, "mlp"), std=0.5),
        "conv_b": ini.param((conv_dim,), ("mlp",), init=zeros),
        "dt_bias": ini.param((H,), ("heads",), init=zeros),
        # A = -exp(A_log), A ~ -1 at init
        "A_log": ini.param((H,), ("heads",), init=zeros),
        "D": ini.param((H,), ("heads",), init=ones),
        "norm_scale": ini.param((d_inner,), ("mlp",), init=ones),
        "out_proj": ini.param((d_inner, d), ("mlp", "embed"),
                              std=d_inner ** -0.5),
    }


def _split_proj(proj, cfg):
    d, d_inner, H, P, N, G = _dims(cfg)
    return torch.split(proj, [d_inner, d_inner, G * N, G * N, H], dim=-1)


def _gated_norm(scale, y, z, eps):
    yf = y.to(torch.float32) * F.silu(z.to(torch.float32))
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(y.dtype)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: torch.Tensor):
    """Depthwise causal conv; ``prev`` is the (conv_w - 1) left context.
    Returns (silu(conv + b), the new left context)."""
    conv_w = w.shape[0]
    S = xBC.shape[1]
    xin = torch.cat([prev, xBC], dim=1)  # (B, S + cw - 1, C)
    out = xin[:, 0:S, :] * w[0][None, None, :]
    for i in range(1, conv_w):
        out = out + xin[:, i:i + S, :] * w[i][None, None, :]
    return F.silu(out + b), xin[:, -(conv_w - 1):, :]


def mamba_forward(p, xin: torch.Tensor, cfg, state: Optional[MambaState] = None,
                  *, executor=None) -> Tuple[torch.Tensor, Optional[MambaState]]:
    """The block over a whole sequence (B, S, d); with ``state`` it also
    returns the state after the sequence (the scan starts from zero, as in
    the JAX package: only the conv window is read from ``state``)."""
    B, S, _ = xin.shape
    d, d_inner, H, P, N, G = _dims(cfg)
    proj = xin @ p["in_proj"]
    z, x, Bc, Cc, dt = _split_proj(proj, cfg)

    xBC = torch.cat([x, Bc, Cc], dim=-1)
    prev = (state.conv if state is not None else
            xBC.new_zeros((B, cfg.ssm_conv - 1, xBC.shape[-1])))
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"], prev)
    x, Bc, Cc = torch.split(xBC, [d_inner, G * N, G * N], dim=-1)

    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    A = -torch.exp(p["A_log"].to(torch.float32))
    xh = x.reshape(B, S, H, P)
    Bm = Bc.reshape(B, S, G, N)
    Cm = Cc.reshape(B, S, G, N)

    y, ssm_state = _ssd_op(xh, dt, A, Bm, Cm, executor=executor)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, d_inner)
    y = _gated_norm(p["norm_scale"], y, z, cfg.norm_eps)
    out = y @ p["out_proj"]

    new_state = None
    if state is not None:
        new_state = MambaState(conv=conv_state, ssm=ssm_state)
    return out, new_state


def mamba_step(p, xin: torch.Tensor, cfg, state: MambaState
               ) -> Tuple[torch.Tensor, MambaState]:
    """O(1) single-token recurrence (decode) of xin (B, 1, d)."""
    B = xin.shape[0]
    d, d_inner, H, P, N, G = _dims(cfg)
    proj = xin @ p["in_proj"]
    z, x, Bc, Cc, dt = _split_proj(proj, cfg)

    xBC = torch.cat([x, Bc, Cc], dim=-1)  # (B, 1, C)
    window = torch.cat([state.conv, xBC], dim=1)  # (B, cw, C)
    conv_out = torch.einsum("btc,tc->bc", window, p["conv_w"]) + p["conv_b"]
    xBC1 = F.silu(conv_out)[:, None, :]
    conv_state = window[:, 1:, :]

    x1, B1, C1 = torch.split(xBC1, [d_inner, G * N, G * N], dim=-1)
    dt1 = F.softplus(dt.to(torch.float32)
                     + p["dt_bias"].to(torch.float32))[:, 0, :]  # (B, H)
    A = -torch.exp(p["A_log"].to(torch.float32))  # (H,)
    xh = x1.reshape(B, H, P).to(torch.float32)
    group = H // G
    Bh = torch.repeat_interleave(B1.reshape(B, G, N), group, dim=1).to(torch.float32)
    Ch = torch.repeat_interleave(C1.reshape(B, G, N), group, dim=1).to(torch.float32)

    decay = torch.exp(dt1 * A[None, :])  # (B, H)
    update = dt1[..., None, None] * Bh[..., :, None] * xh[..., None, :]
    ssm = decay[..., None, None] * state.ssm + update
    y = torch.einsum("bhn,bhnp->bhp", Ch, ssm)
    y = y + p["D"].to(torch.float32)[None, :, None] * xh
    y = y.reshape(B, 1, d_inner).to(xin.dtype)
    y = _gated_norm(p["norm_scale"], y, z, cfg.norm_eps)
    out = y @ p["out_proj"]
    return out, MambaState(conv=conv_state, ssm=ssm)
