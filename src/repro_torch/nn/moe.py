"""Mixture-of-Experts layer: top-k router and sorted grouped-GEMM dispatch.

The port of ``repro/nn/moe.py``.  Three dispatch formulations, the same math:

* ``sort`` (default): tokens are replicated k ways, sorted by expert id
  (a stable ``torch.argsort``), and each expert's SwiGLU runs on its
  contiguous segment of the sorted rows, three products an expert with rows
  — the JAX package's ``jax.lax.ragged_dot`` grouped GEMMs, which are XLA
  ops, not Pallas kernels, so the port's grouped GEMM is plain PyTorch.
  The segment bounds (a ``searchsorted`` of the sorted ids) are read on
  the host once a call.  On ``meta`` tensors (the cost model and the dry
  run, :mod:`repro_torch.launch.dryrun`) there are no ids to read: the rows
  are split over the experts evenly (balanced routing), which gives the
  grouped GEMM's operations for any routing (every row through one expert's
  three products) and reads every expert's weights once.
* ``dense``: every expert processes every token, combined with the routing
  weights — the oracle for the sort path;
* ``ep`` (taken when ``cfg.moe_spec`` names the mesh axes): expert
  parallelism over the model group of the ambient
  :class:`~repro_torch.launch.mesh.Mesh` (``use_mesh``).  Each model rank
  holds E / n experts.  ``cfg.moe_dispatch == "gather"``: every rank sees
  every token of its data shard, fills a fixed-capacity buffer with the
  tokens routed to its experts (GShard capacity with drop), runs their
  grouped GEMM and the ranks' partial outputs are summed (one all-reduce
  over the model group).  ``"a2a"``: each rank routes its sequence shard
  and sends every expert's tokens to the expert's rank in one all-to-all
  (fixed capacity a pair), and a second returns the results; the shards are
  gathered back along the sequence.  ``moe_drop_frac`` reports the dropped
  share; the metrics are averaged over the model group and the data axes.
  Gradients follow :mod:`repro_torch.distributed.parallel`: every model
  rank holds the whole gradient of each parameter it was given.

Router: softmax -> top-k -> renormalise (qwen2 / olmoe), with the
Switch-style load-balance loss and the router z-loss returned as metrics.
qwen2-moe's shared expert is gated by a sigmoid of one projection a token.
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
        "router": ini.param((d, cfg.n_experts), ("embed", None),
                            std=d ** -0.5, dtype=torch.float32),
        "gate": ini.param((E, d, dff), ("expert", "embed", "expert_mlp"),
                          std=d ** -0.5),
        "up": ini.param((E, d, dff), ("expert", "embed", "expert_mlp"),
                        std=d ** -0.5),
        "down": ini.param((E, dff, d), ("expert", "expert_mlp", "embed"),
                          std=dff ** -0.5),
    }
    if cfg.shared_expert_ff:
        sff = cfg.shared_expert_ff
        p["sh_gate"] = ini.param((d, sff), ("embed", "mlp"), std=d ** -0.5)
        p["sh_up"] = ini.param((d, sff), ("embed", "mlp"), std=d ** -0.5)
        p["sh_down"] = ini.param((sff, d), ("mlp", "embed"), std=sff ** -0.5)
        # qwen2-moe gates the shared expert with a sigmoid scalar per token
        p["sh_gate_proj"] = ini.param((d, 1), ("embed", None), std=d ** -0.5)
    return p


def _router(router_w, x2: torch.Tensor, cfg) -> Tuple[
        torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """x2 (T, d) -> (weights (T, k) f32, ids (T, k), aux metrics), in f32."""
    T = x2.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    logits = x2.to(torch.float32) @ router_w  # (T, E)
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


def _segment_swiglu(xs, sorted_ids, gate, up, down) -> torch.Tensor:
    """The grouped GEMM: the rows of each expert's contiguous segment of
    ``xs`` (sorted by expert id) through its SwiGLU, joined in order."""
    E = gate.shape[0]
    if xs.device.type == "meta":
        # no ids to read: equal segments (see the module docstring)
        R = xs.shape[0]
        bounds = [e * (R // E) + min(e, R % E) for e in range(E + 1)]
    else:
        # the segment bounds, read on the host once a call (torch.bincount
        # would read the ids' maximum first: a second host read)
        experts = torch.arange(E + 1, device=sorted_ids.device)
        bounds = torch.searchsorted(sorted_ids, experts).tolist()
    pieces = []  # the experts' outputs in sorted order, joined once
    for e in range(E):
        start, end = bounds[e], bounds[e + 1]
        if end > start:
            seg = xs[start:end]
            h = F.silu(seg @ gate[e]) * (seg @ up[e])
            pieces.append(h @ down[e])
    return torch.cat(pieces)


def _experts_sort(p, x2, weights, ids, cfg) -> torch.Tensor:
    """Sort-based dispatch and a grouped GEMM: the rows of each expert's
    contiguous segment of the sorted (token, slot) pairs go through its
    SwiGLU; the results are put back in (token, slot) order and combined
    with the routing weights."""
    T, d = x2.shape
    k = cfg.top_k

    flat_ids = ids.reshape(-1)  # (T*k,)
    order = torch.argsort(flat_ids, stable=True)
    token_of = order // k  # source token per sorted slot
    xs = x2[token_of]  # (T*k, d) gathered tokens in expert order
    out_s = _segment_swiglu(xs, flat_ids[order], p["gate"], p["up"],
                            p["down"])

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


# =============================================================================
# expert-parallel dispatch (the JAX package's shard_map bodies, one rank each)
# =============================================================================


def _capacity(cfg, T: int, n_cols: int) -> int:
    c = int(cfg.moe_capacity_factor * T * cfg.top_k / max(n_cols, 1))
    return max((c + 7) // 8 * 8, 8)


def _scatter_max(n: int, slot, values) -> torch.Tensor:
    """``zeros(n).at[slot].max(values)``."""
    return torch.zeros(n, dtype=values.dtype, device=values.device) \
        .scatter_reduce(0, slot, values, "amax")


def _experts_ep_body(x2, router_w, gate_l, up_l, down_l, cfg, m: int,
                     n_cols: int):
    """Gather dispatch on model rank ``m`` of ``n_cols``: x2 (T, d) this
    rank's tokens (all the data shard's), *_l its experts.  Returns this
    rank's partial output (T, d) and the metrics."""
    T, d = x2.shape
    E_local = gate_l.shape[0]
    k = cfg.top_k
    weights, ids, metrics = _router(router_w, x2, cfg)

    flat_ids = ids.reshape(-1)  # (T*k,)
    flat_w = weights.reshape(-1)
    tok = torch.arange(T * k, device=x2.device) // k
    lo = m * E_local
    mine = (flat_ids >= lo) & (flat_ids < lo + E_local)
    pos = torch.cumsum(mine.to(torch.int64), dim=0) - 1
    C = _capacity(cfg, T, n_cols)
    keep = mine & (pos < C)
    slot = torch.where(keep, pos, C)  # C = the overflow slot

    # scatter tokens and local expert ids into the fixed buffer
    buf = torch.zeros((C + 1, d), dtype=x2.dtype, device=x2.device).index_add(
        0, slot, torch.where(keep[:, None], x2[tok], 0))
    eid = _scatter_max(C + 1, slot, torch.where(keep, flat_ids - lo, 0))

    # order by local expert id; empty slots carry zeros into expert 0
    order = torch.argsort(eid[:C], stable=True)
    xs = buf[:C][order]
    out_s = _segment_swiglu(xs, eid[:C][order], gate_l, up_l, down_l)

    inv = torch.argsort(order)
    out_buf = torch.cat([out_s[inv], out_s.new_zeros((1, d))])
    contrib = out_buf[slot] * torch.where(keep, flat_w, 0.0)[:, None].to(out_s.dtype)
    y2 = torch.sum(contrib.reshape(T, k, d), dim=1)  # this rank's part only
    drop = 1.0 - keep.sum() / torch.clamp(mine.sum(), min=1)
    return y2, {**metrics,
                "moe_drop_frac": drop.to(torch.float32)}


def _experts_ep_a2a_body(x2, router_w, gate_l, up_l, down_l, cfg, n_cols: int,
                         group):
    """All-to-all dispatch: x2 (T_l, d) this rank's sequence shard.  The
    tokens routed to remote experts go out in one all-to-all (a fixed
    capacity a rank pair), the local experts run on what arrives, and a
    second all-to-all brings the results back: no output all-reduce."""
    from repro_torch.distributed import comm, parallel

    T, d = x2.shape
    E_local = gate_l.shape[0]
    k = cfg.top_k
    weights, ids, metrics = _router(router_w, x2, cfg)

    flat_ids = ids.reshape(-1)
    flat_w = weights.reshape(-1)
    tok = torch.arange(T * k, device=x2.device) // k
    dest = flat_ids // E_local  # owning rank per assignment
    local_eid = flat_ids % E_local

    # per-destination positions (running count of assignments to each rank)
    dest_onehot = F.one_hot(dest, n_cols)
    pos = torch.cumsum(dest_onehot, dim=0) - dest_onehot  # exclusive
    pos = torch.sum(pos * dest_onehot, dim=1)

    # pair capacity: the mean T k / n_cols with slack (pairs balance worse
    # than ranks, hence the 2x)
    C = max(int(2.0 * cfg.moe_capacity_factor * T * k / max(n_cols, 1) + 7)
            // 8 * 8, 8)
    keep = pos < C
    slot = torch.where(keep, dest * C + pos, n_cols * C)  # overflow slot

    send_x = torch.zeros((n_cols * C + 1, d), dtype=x2.dtype,
                         device=x2.device).index_add(
        0, slot, torch.where(keep[:, None], x2[tok], 0))[:-1]
    send_eid = _scatter_max(n_cols * C + 1, slot,
                            torch.where(keep, local_eid, 0))[:-1]
    send_valid = _scatter_max(n_cols * C + 1, slot, keep.to(torch.int64))[:-1]

    recv_x = parallel.all_to_all(send_x.reshape(n_cols, C, d), group) \
        .reshape(n_cols * C, d)
    recv_eid = comm.all_to_all(send_eid.reshape(n_cols, C), group).reshape(-1)
    recv_valid = comm.all_to_all(send_valid.reshape(n_cols, C),
                                 group).reshape(-1) > 0

    recv_eid = torch.where(recv_valid, recv_eid, 0)  # invalid slots: expert 0
    order = torch.argsort(recv_eid, stable=True)
    out_s = _segment_swiglu(recv_x[order], recv_eid[order], gate_l, up_l,
                            down_l)
    inv = torch.argsort(order)
    out_buf = out_s[inv] * recv_valid[:, None].to(out_s.dtype)

    back = parallel.all_to_all(out_buf.reshape(n_cols, C, d), group) \
        .reshape(n_cols * C, d)
    back = torch.cat([back, back.new_zeros((1, d))])
    contrib = back[slot] * torch.where(keep, flat_w, 0.0)[:, None].to(back.dtype)
    y2 = torch.zeros((T, d), dtype=x2.dtype, device=x2.device).index_add(
        0, tok, contrib.to(x2.dtype))
    drop = 1.0 - keep.sum() / max(T * k, 1)
    return y2, {**metrics,
                "moe_drop_frac": drop.to(torch.float32)}


def _experts_ep(p, x, cfg, mesh):
    """Expert-parallel MoE on this rank: x (B_l, S, d) its data shard,
    replicated over the model group -> (y (B_l, S, d), metrics)."""
    from repro_torch.distributed import parallel

    batch_axes, model_axis = cfg.moe_spec
    mgroup = mesh.group(model_axis)
    bgroup = mesh.group(batch_axes)
    n_cols = mesh.axis_size(model_axis)
    m = mesh.index(model_axis)
    a2a = cfg.moe_dispatch == "a2a"
    E_pad = p["gate"].shape[0]
    if E_pad % n_cols:
        raise ValueError(f"{cfg.name}: {E_pad} experts do not split over "
                         f"{n_cols} model ranks")
    E_local = E_pad // n_cols
    B_l, S, d = x.shape

    router_w = parallel.enter(p["router"], mgroup)
    gate_l, up_l, down_l = (parallel.take(p[n], 0, m * E_local, E_local,
                                          mgroup)
                            for n in ("gate", "up", "down"))
    if a2a:
        if S % n_cols:
            raise ValueError(f"sequence {S} does not split over {n_cols} "
                             "model ranks")
        x_l = parallel.take(x, 1, m * (S // n_cols), S // n_cols, mgroup)
        x2 = x_l.reshape(-1, d)
        y2, metrics = _experts_ep_a2a_body(x2, router_w, gate_l, up_l, down_l,
                                           cfg, n_cols, mgroup)
    else:
        x_l = parallel.enter(x, mgroup)
        x2 = x_l.reshape(-1, d)
        y2, metrics = _experts_ep_body(x2, router_w, gate_l, up_l, down_l,
                                       cfg, m, n_cols)
    if "sh_gate" in p:
        if a2a:
            # the shared expert runs on the local tokens with whole weights
            sh_gate, sh_up, sh_down, sh_proj = (
                parallel.enter(p[n], mgroup)
                for n in ("sh_gate", "sh_up", "sh_down", "sh_gate_proj"))
        else:
            # its hidden dim split over the model ranks, summed with y2
            sff = p["sh_gate"].shape[1]
            if sff % n_cols:
                raise ValueError(f"shared expert {sff} does not split over "
                                 f"{n_cols} model ranks")
            h = sff // n_cols
            sh_gate = parallel.take(p["sh_gate"], 1, m * h, h, mgroup)
            sh_up = parallel.take(p["sh_up"], 1, m * h, h, mgroup)
            sh_down = parallel.take(p["sh_down"], 0, m * h, h, mgroup)
            sh_proj = parallel.enter(p["sh_gate_proj"], mgroup)
        shp = (F.silu(x2 @ sh_gate) * (x2 @ sh_up)) @ sh_down
        gate_sc = torch.sigmoid(x2.to(torch.float32)
                                @ sh_proj.to(torch.float32))
        y2 = y2 + shp.to(y2.dtype) * gate_sc.to(y2.dtype)
    if not a2a:
        y2 = parallel.leave(y2, mgroup)  # combine the expert ranks
    metrics = {key: parallel.mean(parallel.mean(v, mgroup,
                                                parallel.group_size(mgroup)),
                                  bgroup)
               for key, v in metrics.items()}
    y = y2.reshape(B_l, -1, d)
    if a2a:
        y = parallel.gather(y, 1, mgroup)
    return y, metrics


def moe_forward(p, x: torch.Tensor, cfg, *, impl: str = None, mesh=None):
    """x (B, S, d) -> (y, metrics).  impl: "sort" | "dense" | "ep" (the
    default is "ep" when cfg.moe_spec is set, else "sort"); "ep" runs over
    ``mesh`` (the ambient mesh, ``use_mesh``, when None)."""
    if impl is None:
        impl = "ep" if cfg.moe_spec else "sort"
    if impl == "ep":
        if mesh is None:
            from repro_torch.launch.mesh import current_mesh

            mesh = current_mesh()
        if mesh is None:
            raise ValueError(f"{cfg.name}: the expert-parallel dispatch "
                             f"(moe_spec={cfg.moe_spec!r}) needs a mesh "
                             "(repro_torch.launch.mesh.use_mesh)")
        return _experts_ep(p, x, cfg, mesh)

    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    weights, ids, metrics = _router(p["router"], x2, cfg)
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
