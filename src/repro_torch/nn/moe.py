"""Mixture-of-Experts layer: top-k router and sorted grouped-GEMM dispatch.

The port of ``repro/nn/moe.py``.  Two dispatch formulations, the same math:

* ``sort`` (default): tokens are replicated k ways, sorted by expert id
  (a stable ``torch.argsort``), and each expert's SwiGLU runs on its
  contiguous segment of the sorted rows, three products an expert with rows
  — the JAX package's ``jax.lax.ragged_dot`` grouped GEMMs, which are XLA
  ops, not Pallas kernels, so the port's grouped GEMM is plain PyTorch.
  The segment bounds (a ``searchsorted`` of the sorted ids) are read on
  the host once a call.
* ``dense``: every expert processes every token, combined with the routing
  weights — the oracle for the sort path.

Router: softmax -> top-k -> renormalise (qwen2 / olmoe), with the
Switch-style load-balance loss and the router z-loss returned as metrics.
qwen2-moe's shared expert is gated by a sigmoid of one projection a token.

The JAX package's expert-parallel dispatch (``impl="ep"``, taken when
``cfg.moe_spec`` names a mesh) runs only under a mesh and is not ported
(ROADMAP A.10).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.nn.common import Initializer

__all__ = ["padded_experts", "moe_init", "moe_forward"]


def padded_experts(cfg) -> int:
    """Expert count padded for even expert-parallel sharding (qwen2: 60->64).

    Padded experts get no router column, so no token routes to them: their
    groups are empty and they never compute.
    """
    return cfg.n_experts_padded or cfg.n_experts


def moe_init(ini: Initializer, cfg) -> dict:
    """The router in f32, the expert stacks (E_pad, ...) and the shared
    expert (with its gate projection) in the model's dtype."""
    d, E, dff = cfg.d_model, padded_experts(cfg), cfg.d_expert
    p = {
        "router": ini.param((d, cfg.n_experts), std=d ** -0.5,
                            dtype=torch.float32),
        "gate": ini.param((E, d, dff), std=d ** -0.5),
        "up": ini.param((E, d, dff), std=d ** -0.5),
        "down": ini.param((E, dff, d), std=dff ** -0.5),
    }
    if cfg.shared_expert_ff:
        sff = cfg.shared_expert_ff
        p["sh_gate"] = ini.param((d, sff), std=d ** -0.5)
        p["sh_up"] = ini.param((d, sff), std=d ** -0.5)
        p["sh_down"] = ini.param((sff, d), std=sff ** -0.5)
        # qwen2-moe gates the shared expert with a sigmoid scalar per token
        p["sh_gate_proj"] = ini.param((d, 1), std=d ** -0.5)
    return p


def _router(p, x2: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor,
                                                Dict[str, torch.Tensor]]:
    """x2 (T, d) -> (weights (T, k) f32, ids (T, k), aux metrics), in f32."""
    T = x2.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    logits = x2.to(torch.float32) @ p["router"]  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, k, dim=-1)  # sorted, largest first
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)

    # Switch-style load-balance loss: E * sum_e fraction_e * mean_prob_e;
    # the counts as the JAX package's one-hot sum (no host read, unlike
    # torch.bincount on the card)
    experts = torch.arange(E, device=ids.device)
    counts = (ids.reshape(-1, 1) == experts).sum(dim=0).to(torch.float32)
    fraction = counts / max(T * k, 1)
    mean_prob = torch.mean(probs, dim=0)
    lb_loss = E * torch.sum(fraction * mean_prob)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return weights, ids, {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss}


def _experts_sort(p, x2, weights, ids, cfg) -> torch.Tensor:
    """Sort-based dispatch and a grouped GEMM: the rows of each expert's
    contiguous segment of the sorted (token, slot) pairs go through its
    SwiGLU; the results are put back in (token, slot) order and combined
    with the routing weights."""
    T, d = x2.shape
    E, k = p["gate"].shape[0], cfg.top_k  # padded expert count

    flat_ids = ids.reshape(-1)  # (T*k,)
    order = torch.argsort(flat_ids, stable=True)
    token_of = order // k  # source token per sorted slot
    xs = x2[token_of]  # (T*k, d) gathered tokens in expert order
    # the segment bounds, read on the host once a call (torch.bincount
    # would read the ids' maximum first: a second host read)
    experts = torch.arange(E + 1, device=flat_ids.device)
    bounds = torch.searchsorted(flat_ids[order], experts).tolist()

    pieces = []  # the experts' outputs in sorted order, joined once
    for e in range(E):
        start, end = bounds[e], bounds[e + 1]
        if end > start:
            seg = xs[start:end]
            h = F.silu(seg @ p["gate"][e]) * (seg @ p["up"][e])
            pieces.append(h @ p["down"][e])
    out_s = torch.cat(pieces)

    out = torch.empty_like(out_s)
    out[order] = out_s  # back to (token, slot) order
    out = out.reshape(T, k, d)
    return torch.sum(out * weights[..., None].to(out.dtype), dim=1)


def _experts_dense(p, x2, weights, ids, cfg) -> torch.Tensor:
    """Oracle: every expert on every token, masked combine."""
    E = p["gate"].shape[0]
    gate = torch.einsum("td,edf->tef", x2, p["gate"])
    up = torch.einsum("td,edf->tef", x2, p["up"])
    h = F.silu(gate) * up
    out_e = torch.einsum("tef,efd->ted", h, p["down"])  # (T, E, d)
    one_hot = F.one_hot(ids, E).to(torch.float32)  # (T, k, E)
    combine = torch.sum(one_hot * weights[..., None], dim=1)  # (T, E)
    return torch.einsum("te,ted->td", combine.to(out_e.dtype), out_e)


def moe_forward(p, x: torch.Tensor, cfg, *, impl: str = None):
    """x (B, S, d) -> (y, metrics).  impl: "sort" (default) | "dense"; the
    JAX package's "ep" (its default when cfg.moe_spec is set) is not
    ported."""
    if impl is None:
        impl = "ep" if cfg.moe_spec else "sort"
    if impl == "ep":
        raise NotImplementedError(
            f"{cfg.name}: the expert-parallel MoE dispatch (impl='ep', "
            f"moe_spec={cfg.moe_spec!r}) runs under a mesh and is not ported "
            "to repro_torch yet (ROADMAP A.10)")

    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    weights, ids, metrics = _router(p, x2, cfg)
    if impl == "sort":
        y2 = _experts_sort(p, x2, weights, ids, cfg)
    elif impl == "dense":
        y2 = _experts_dense(p, x2, weights, ids, cfg)
    else:
        raise ValueError(f"unknown moe impl {impl!r}")

    if "sh_gate" in p:
        sh = (F.silu(x2 @ p["sh_gate"]) * (x2 @ p["sh_up"])) @ p["sh_down"]
        sh_gate = torch.sigmoid(x2.to(torch.float32)
                                @ p["sh_gate_proj"].to(torch.float32))
        y2 = y2 + sh.to(y2.dtype) * sh_gate.to(y2.dtype)

    return y2.reshape(B, S, d), metrics
