"""Scratch of the single-pass reductions (``finish_sum`` in ``csrc/common.cuh``):
the blocks' partials and the tickets that elect each sum's last block.

One workspace per (kernel, device, stream), kept for the process.  Its
tickets are zeroed once, when they are allocated, and never again: the last
block of every sum sets its ticket back to 0 itself.  Launches on one stream
run in order, so one call's kernel never meets another's partials or
tickets.  A larger request replaces the buffers once (a new zeroed ticket
array); a solver loop, whose shapes do not change, allocates nothing after
its first call.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["workspace"]

_CACHE: Dict[Tuple[str, torch.device, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def workspace(name: str, device: torch.device, stream: int, tickets: int,
              partial_bytes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tickets, partials): at least ``tickets`` zeroed int32 tickets and
    ``partial_bytes`` bytes of partials on ``device`` for kernel ``name``
    launched on ``stream``."""
    key = (name, device, stream)
    t, p = _CACHE.get(key, (None, None))
    if t is None or t.numel() < tickets or p.numel() < partial_bytes:
        t = torch.zeros(max(tickets, 1, 0 if t is None else t.numel()),
                        dtype=torch.int32, device=device)
        p = torch.empty(max(partial_bytes, 8, 0 if p is None else p.numel()),
                        dtype=torch.uint8, device=device)
        _CACHE[key] = (t, p)
    return t, p
