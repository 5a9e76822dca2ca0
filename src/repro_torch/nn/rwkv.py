"""RWKV6 (Finch) blocks: time-mix (WKV attention) + channel-mix.

The port of ``repro/nn/rwkv.py`` (arXiv:2404.05892): token shift with
data-dependent linear interpolation (one shared LoRA produces the five
deltas r, k, v, w, g, as in the JAX package), per-channel data-dependent
decay ``w = exp(-exp(w0 + lora(x)))`` kept in log space (``logw =
-exp(.)``), bonus ``u``, head-wise group norm, and the squared-ReLU channel
mix.  The WKV recurrence over a sequence is the registered
``nn_rwkv6_scan`` operation (reference = sequential recurrence, torch =
chunked products, cuda = the kernel); decode steps the recurrence in plain
PyTorch, as the JAX package does.

Casts and rounding follow the JAX package: ``w0 + lora`` is added in the
model's dtype and cast to f32 before the exp; the scan's y comes back in r's
dtype; the decode step casts y to x's dtype before the group norm (eps
64e-5).  As in the JAX package, ``time_mix_forward`` starts the WKV state
from zero whatever ``state.wkv`` holds (the scan has no initial-state
input): only the token shifts are read from ``state`` (ROADMAP C5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import registry
from repro_torch.nn.common import Initializer, zeros
from repro_torch.nn.layers import groupnorm

# make sure the kernel spaces are populated
import repro_torch.kernels  # noqa: F401

__all__ = ["RWKVState", "time_mix_init", "time_mix_forward", "time_mix_step",
           "channel_mix_init", "channel_mix_forward"]

_rwkv6_op = registry.operation("nn_rwkv6_scan")

_GN_EPS = 64e-5


@dataclasses.dataclass
class RWKVState:
    """Per-layer recurrent state for decode."""

    wkv: torch.Tensor  # (B, H, K, V) WKV matrix state, f32
    shift_tm: torch.Tensor  # (B, d) previous token (time-mix)
    shift_cm: torch.Tensor  # (B, d) previous token (channel-mix)


def time_mix_init(ini: Initializer, cfg) -> dict:
    d = cfg.d_model
    H = d // cfg.rwkv_head_dim
    K = cfg.rwkv_head_dim
    r = cfg.lora_rank // 2 if cfg.lora_rank else 64
    return {
        # token-shift interpolation bases (five channels: r, k, v, w, g)
        "mix_base": ini.param((5, d), (None, "embed"), std=0.02),
        "mix_lora_a": ini.param((d, r), ("embed", None), std=d ** -0.5),
        "mix_lora_b": ini.param((r, 5 * d), (None, "embed"), init=zeros),
        # projections
        "wr": ini.param((d, d), ("embed", "heads"), std=d ** -0.5),
        "wk": ini.param((d, d), ("embed", "heads"), std=d ** -0.5),
        "wv": ini.param((d, d), ("embed", "heads"), std=d ** -0.5),
        "wg": ini.param((d, d), ("embed", "heads"), std=d ** -0.5),
        "wo": ini.param((d, d), ("heads", "embed"), std=d ** -0.5),
        # decay: logw = -exp(w0 + lora(x))
        "w0": ini.param((d,), ("embed",), init=zeros),
        "w_lora_a": ini.param((d, r), ("embed", None), std=d ** -0.5),
        "w_lora_b": ini.param((r, d), (None, "embed"), init=zeros),
        "u": ini.param((H, K), ("heads", None), std=0.02),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x[t-1] with x[-1] = prev (B, d)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _mixed(p, x: torch.Tensor, xs: torch.Tensor):
    """Data-dependent lerp between x and shifted xs for 5 channels."""
    delta = torch.tanh(x @ p["mix_lora_a"]) @ p["mix_lora_b"]  # (B, S, 5d)
    B, S, d = x.shape
    mix = torch.sigmoid(p["mix_base"][None, None] + delta.reshape(B, S, 5, d))
    out = x[:, :, None, :] + mix * (xs - x)[:, :, None, :]  # (B, S, 5, d)
    return tuple(out[:, :, i, :] for i in range(5))


def _log_decay(p, xw: torch.Tensor) -> torch.Tensor:
    """logw = -exp(w0 + tanh(xw A) B): added in the model's dtype, then f32."""
    z = p["w0"] + torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    return -torch.exp(z.to(torch.float32))


def time_mix_forward(p, x: torch.Tensor, cfg, state: Optional[RWKVState] = None,
                     *, executor=None) -> Tuple[torch.Tensor, Optional[RWKVState]]:
    """Full-sequence WKV time-mix of x (B, S, d).  Returns (y, the state
    after the sequence or None); the WKV state starts from zero."""
    B, S, d = x.shape
    K = cfg.rwkv_head_dim
    H = d // K
    prev = state.shift_tm if state is not None else x.new_zeros((B, d))
    xs = _token_shift(x, prev)
    xr, xk, xv, xw, xg = _mixed(p, x, xs)

    r = (xr @ p["wr"]).reshape(B, S, H, K)
    k = (xk @ p["wk"]).reshape(B, S, H, K)
    v = (xv @ p["wv"]).reshape(B, S, H, K)
    g = xg @ p["wg"]
    logw = _log_decay(p, xw).reshape(B, S, H, K)

    y, wkv_state = _rwkv6_op(r, k, v, logw, p["u"], executor=executor)
    y = groupnorm(y.reshape(B, S, d), H, eps=_GN_EPS)
    y = y * F.silu(g)
    out = y @ p["wo"]
    new_state = None
    if state is not None:
        new_state = RWKVState(wkv=wkv_state, shift_tm=x[:, -1, :],
                              shift_cm=state.shift_cm)
    return out, new_state


def time_mix_step(p, x: torch.Tensor, cfg,
                  state: RWKVState) -> Tuple[torch.Tensor, RWKVState]:
    """Single-token recurrent step (decode) of x (B, 1, d), in plain
    PyTorch: r, k, v and the state in f32."""
    B, _, d = x.shape
    K = cfg.rwkv_head_dim
    H = d // K
    xs = state.shift_tm[:, None, :]
    xr, xk, xv, xw, xg = _mixed(p, x, xs)

    r = (xr @ p["wr"]).reshape(B, H, K).to(torch.float32)
    k = (xk @ p["wk"]).reshape(B, H, K).to(torch.float32)
    v = (xv @ p["wv"]).reshape(B, H, K).to(torch.float32)
    g = xg @ p["wg"]
    logw = _log_decay(p, xw).reshape(B, H, K)
    u = p["u"].to(torch.float32)

    kv = k[..., :, None] * v[..., None, :]  # (B, H, K, V)
    att = state.wkv + u[None, :, :, None] * kv
    y = torch.einsum("bhk,bhkv->bhv", r, att)  # (B, H, V)
    wkv = torch.exp(logw)[..., None] * state.wkv + kv

    y = groupnorm(y.reshape(B, 1, d).to(x.dtype), H, eps=_GN_EPS)
    y = y * F.silu(g)
    out = y @ p["wo"]
    return out, RWKVState(wkv=wkv, shift_tm=x[:, -1, :], shift_cm=state.shift_cm)


def channel_mix_init(ini: Initializer, cfg) -> dict:
    d, dff = cfg.d_model, cfg.d_ff
    return {
        "mix_k": ini.param((d,), ("embed",), std=0.02),
        "mix_r": ini.param((d,), ("embed",), std=0.02),
        "wk": ini.param((d, dff), ("embed", "mlp"), std=d ** -0.5),
        "wv": ini.param((dff, d), ("mlp", "embed"), std=dff ** -0.5),
        "wr": ini.param((d, d), ("embed", "embed"), std=d ** -0.5),
    }


def channel_mix_forward(p, x: torch.Tensor, cfg,
                        state: Optional[RWKVState] = None
                        ) -> Tuple[torch.Tensor, Optional[RWKVState]]:
    """Squared-ReLU channel mix with a token shift, for a sequence or one
    decode token."""
    B, S, d = x.shape
    prev = state.shift_cm if state is not None else x.new_zeros((B, d))
    xs = _token_shift(x, prev)
    mk = torch.sigmoid(p["mix_k"])
    mr = torch.sigmoid(p["mix_r"])
    xk = x + mk * (xs - x)
    xr = x + mr * (xs - x)
    k = torch.square(torch.relu(xk @ p["wk"]))
    out = torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])
    new_state = None
    if state is not None:
        new_state = RWKVState(wkv=state.wkv, shift_tm=state.shift_tm,
                              shift_cm=x[:, -1, :])
    return out, new_state
