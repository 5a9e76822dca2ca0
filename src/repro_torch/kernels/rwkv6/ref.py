"""The sequential WKV6 recurrence: the oracle of the ``reference`` space
(the port of ``repro/kernels/rwkv6/ref.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["rwkv6_ref"]


def rwkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              s0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T),
    S_t = diag(w_t) S_{t-1} + k_t v_t^T, one step at a time, in f32.

    r, k, w (B, S, H, K), v (B, S, H, V), u (H, K), ``s0`` (B, H, K, V) the
    initial state (zero when None); returns (y (B, S, H, V) in r's dtype,
    the final state (B, H, K, V) f32)."""
    Bsz, S, H, K = r.shape
    V = v.shape[-1]
    rf, kf, vf, wf = (t.to(torch.float32) for t in (r, k, v, w))
    uf = u.to(torch.float32)
    state = (torch.zeros((Bsz, H, K, V), dtype=torch.float32, device=r.device)
             if s0 is None else s0.to(torch.float32))
    ys = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B, H, K, V)
        att = state + uf[None, :, :, None] * kv
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], att))
        state = wf[:, t, :, :, None] * state + kv
    y = torch.stack(ys, dim=1) if ys else vf.new_zeros((Bsz, 0, H, V))
    return y.to(r.dtype), state
