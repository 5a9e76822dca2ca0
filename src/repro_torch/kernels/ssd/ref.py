"""The sequential SSD recurrence: the oracle of the ``reference`` space
(the port of ``repro/kernels/ssd/ref.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["ssd_ref"]


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B_mat: torch.Tensor, C: torch.Tensor,
            h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,  y_t = C_t^T h_t, one step
    at a time; returns (y (B, S, H, P) in x's dtype, final state (B, H, N, P)
    f32)."""
    Bsz, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    group = H // G
    xf, dtf = x.to(torch.float32), dt.to(torch.float32)
    Bh = torch.repeat_interleave(B_mat.to(torch.float32), group, dim=2)
    Ch = torch.repeat_interleave(C.to(torch.float32), group, dim=2)
    Af = A.to(torch.float32)
    h = (torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0.to(torch.float32))
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af[None, :])  # (B, H)
        update = (dtf[:, t, :, None, None] * Bh[:, t, :, :, None]
                  * xf[:, t, :, None, :])
        h = decay[..., None, None] * h + update
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], h))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((Bsz, 0, H, P))
    return y.to(x.dtype), h
