"""Basic layers: linear, RMSNorm, LayerNorm, group norm, rotary embeddings,
SwiGLU and GELU MLPs, embeddings.

The port of ``repro/nn/layers.py``.
RMSNorm goes through the registered ``nn_rmsnorm`` operation (reference /
torch / cuda); LayerNorm and the parameter-free group norm are plain
PyTorch, as the JAX package has no Pallas kernel for them.  Matrix products
are plain ``@`` on the JAX layout (``(d_in, d_out)`` weights, ``x @ W``),
which PyTorch sends to cuBLAS on the card as the JAX package left them to
XLA.  GELU is the tanh approximation, ``jax.nn.gelu``'s default (PyTorch's
default, the exact erf form, differs by about 1e-3).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import registry
from repro_torch.nn.common import Initializer, ones, zeros

# make sure the kernel spaces are populated
import repro_torch.kernels  # noqa: F401

__all__ = ["linear_init", "linear", "rmsnorm_init", "rmsnorm",
           "layernorm_init", "layernorm", "groupnorm", "rope_frequencies",
           "apply_rope", "swiglu_init", "swiglu", "gelu_mlp_init", "gelu_mlp",
           "embedding_init", "embed", "unembed"]

_rmsnorm_op = registry.operation("nn_rmsnorm")


# -- linear ---------------------------------------------------------------------


def linear_init(ini: Initializer, d_in: int, d_out: int,
                axes=(None, None), *, std: Optional[float] = None,
                bias: bool = False) -> dict:
    p = {"w": ini.param((d_in, d_out), axes,
                        std=std if std is not None else d_in ** -0.5)}
    if bias:
        p["b"] = ini.param((d_out,), (axes[1],), init=zeros)
    return p


def linear(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# -- norms ------------------------------------------------------------------------


def rmsnorm_init(ini: Initializer, d: int, *,
                 dtype: torch.dtype = torch.float32) -> dict:
    """The scale is f32 whatever the model's dtype unless ``dtype`` says
    otherwise, as in the JAX package (MLA's q / kv norms take the model's
    dtype)."""
    return {"scale": ini.param((d,), ("embed",), init=ones, dtype=dtype)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6, *, executor=None) -> torch.Tensor:
    return _rmsnorm_op(x, p["scale"], eps, executor=executor)


def layernorm_init(ini: Initializer, d: int) -> dict:
    """Scale and bias are f32 whatever the model's dtype, as in the JAX
    package."""
    return {"scale": ini.param((d,), ("embed",), init=ones,
                               dtype=torch.float32),
            "bias": ini.param((d,), ("embed",), init=zeros,
                              dtype=torch.float32)}


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Statistics in f32, the output in x's dtype."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(x.dtype)


def groupnorm(x: torch.Tensor, num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Parameter-free group norm over the last axis (RWKV6 head norm):
    statistics in f32, the output in x's dtype."""
    *lead, d = x.shape
    xf = x.to(torch.float32).reshape(*lead, num_groups, d // num_groups)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.reshape(*lead, d).to(x.dtype)


# -- rotary embeddings -------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 10000.0, *,
                     device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies (f32)."""
    if head_dim % 2:
        raise ValueError(f"rope head_dim must be even, got {head_dim}")
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Llama-style interleaved-half rotary embedding of ``x`` (B, S, H, D) or
    (B, S, D) at ``positions`` (B, S), computed in f32."""
    d = x.shape[-1]
    inv_freq = rope_frequencies(d, theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * inv_freq  # (B, S, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    if x.ndim == 4:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.cat([rx1, rx2], dim=-1).to(x.dtype)


# -- MLPs -------------------------------------------------------------------------


def swiglu_init(ini: Initializer, d: int, d_ff: int) -> dict:
    return {
        "gate": ini.param((d, d_ff), ("embed", "mlp"), std=d ** -0.5),
        "up": ini.param((d, d_ff), ("embed", "mlp"), std=d ** -0.5),
        "down": ini.param((d_ff, d), ("mlp", "embed"), std=d_ff ** -0.5),
    }


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["gate"]) * (x @ p["up"])) @ p["down"]


def gelu_mlp_init(ini: Initializer, d: int, d_ff: int, *, bias: bool = True) -> dict:
    p = {
        "up": ini.param((d, d_ff), ("embed", "mlp"), std=d ** -0.5),
        "down": ini.param((d_ff, d), ("mlp", "embed"), std=d_ff ** -0.5),
    }
    if bias:
        p["up_b"] = ini.param((d_ff,), ("mlp",), init=zeros)
        p["down_b"] = ini.param((d,), ("embed",), init=zeros)
    return p


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["up"]
    if "up_b" in p:
        h = h + p["up_b"]
    h = F.gelu(h, approximate="tanh")
    y = h @ p["down"]
    if "down_b" in p:
        y = y + p["down_b"]
    return y


# -- embedding ----------------------------------------------------------------------


def embedding_init(ini: Initializer, vocab: int, d: int, *, std: float = 0.02) -> dict:
    return {"table": ini.param((vocab, d), ("vocab", "embed"), std=std)}


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def unembed(p, h: torch.Tensor) -> torch.Tensor:
    """logits = h @ table^T (tied embeddings)."""
    return h @ p["table"].T
