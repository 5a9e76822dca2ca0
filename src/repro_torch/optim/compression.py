"""Int8 gradient compression with error feedback: the port of
``repro/optim/compression.py``.

The classic error-feedback scheme (1-bit Adam lineage)::

    q, scale = quantize(g + e)          # per-tensor symmetric int8
    e        = (g + e) - dequantize(q)  # residual carried to the next step
    g_sync   = all_reduce(q) * scale    # the collective runs on int8 payload

:func:`compressed_psum` is the data-parallel building block over a
``torch.distributed`` group: a ``MAX`` all-reduce of the local amaxes (one
shared scale a leaf), then a ``SUM`` all-reduce of the int8 payload widened
to int32 (gloo and NCCL both take int32).  Each collective carries every
leaf at once: one all-reduce of the amaxes, one of the concatenated
payloads.  Without a process group it is a world of one.
:func:`compressed_mean_local` is the same reduction over a list of ranks'
trees in one process: the plain reference a distributed run is held to.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core import tree as tree_lib

__all__ = ["quantize_int8", "dequantize_int8", "ef_compress",
           "init_error_state", "compress_tree", "decompress_tree",
           "compressed_psum"]


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    return torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))


def _quantize(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    xf = x.to(torch.float32)
    scale = _scale_of(torch.max(torch.abs(xf)))
    return _quantize(xf, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def ef_compress(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback compress one tensor: returns (q, scale, new_err)."""
    corrected = g.to(torch.float32) + err
    q, scale = quantize_int8(corrected)
    return q, scale, corrected - dequantize_int8(q, scale)


def init_error_state(grads: Any) -> Any:
    return tree_lib.zeros_like_tree(grads, torch.float32)


def compress_tree(grads: Any, err_state: Any):
    """Tree-wise EF compression. Returns ((q_tree, scale_tree), new_err)."""
    out = tree_lib.tree_map(ef_compress, grads, err_state, is_leaf=None)
    pick = lambda i: tree_lib.tree_map(  # noqa: E731
        lambda t: t[i], out, is_leaf=lambda n: isinstance(n, tuple))
    return (pick(0), pick(1)), pick(2)


def decompress_tree(q_tree: Any, scale_tree: Any, like: Any) -> Any:
    return tree_lib.tree_map(lambda q, s, g: dequantize_int8(q, s, g.dtype),
                             q_tree, scale_tree, like)


@torch.no_grad()
def compressed_psum(grads: Any, err_state: Any, group=None):
    """EF-compressed mean over the ranks of ``group``: returns (the mean
    gradient tree in each leaf's dtype, this rank's new error tree).

    Every rank dequantizes with the largest amax of the group (a ``MAX``
    all-reduce), so the sum is exact in the quantized domain; the int8
    payload is summed in int32."""
    from repro_torch.distributed import comm

    gs, es = tree_lib.leaves(grads), tree_lib.leaves(err_state)
    corrected = [g.to(torch.float32) + e for g, e in zip(gs, es)]
    amax_local = torch.stack([torch.max(torch.abs(c)) for c in corrected])
    amax = comm.all_reduce(amax_local, "max", group)
    n = 1
    if comm._initialized():
        import torch.distributed as dist

        n = dist.get_world_size(group)
    scales = _scale_of(amax)
    qs = [_quantize(c, s) for c, s in zip(corrected, scales)]
    new_err = [c - q.to(torch.float32) * s
               for c, q, s in zip(corrected, qs, scales)]
    qsum = comm.all_reduce(torch.cat([q.reshape(-1).to(torch.int32)
                                      for q in qs]), "sum", group)
    out, at = [], 0
    for g, s in zip(gs, scales):
        part = qsum[at:at + g.numel()].reshape(g.shape)
        at += g.numel()
        out.append((part.to(torch.float32) * s / n).to(g.dtype))
    it_g, it_e = iter(out), iter(new_err)
    return (tree_lib.tree_map(lambda _: next(it_g), grads),
            tree_lib.tree_map(lambda _: next(it_e), err_state))
